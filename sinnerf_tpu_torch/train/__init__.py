"""Checkpoint interop (counterpart of ``sinnerf_tpu/train``)."""
