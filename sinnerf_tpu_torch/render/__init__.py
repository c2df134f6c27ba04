"""Ray rendering (counterpart of ``sinnerf_tpu/render``)."""
