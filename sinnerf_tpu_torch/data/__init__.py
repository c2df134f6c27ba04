"""Eval datasets and scene generators (counterpart of ``sinnerf_tpu/data``)."""
