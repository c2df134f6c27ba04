"""The NeRF MLP (counterpart of ``sinnerf_tpu/models``)."""
