"""Rays, positional encoding, sampling and compositing (counterpart of ``sinnerf_tpu/core``)."""
