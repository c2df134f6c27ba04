"""Data parallelism over cards (counterpart of ``sinnerf_tpu/parallel``)."""
