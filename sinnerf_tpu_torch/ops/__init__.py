"""Hand-written CUDA kernels, their wrappers and plain versions (counterpart of ``sinnerf_tpu/ops``)."""
