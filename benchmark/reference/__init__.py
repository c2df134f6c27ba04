"""The plain reference the benchmark holds the port to: plain PyTorch and
NumPy, importing nothing of ``sinnerf_tpu_torch``, ``sinnerf_tpu`` or JAX.

The NeRF, its positional encoding, compositing, ``sample_pdf``, the losses,
the ViT, the discriminator and DiffAugment are a frozen copy of the port's
plain code (``sinnerf_tpu_torch`` at the commit that added the benchmark),
trimmed to what the benchmark's recipes run; ``render``, ``step`` and
``scene`` are the benchmark's own.  The program may change; this copy does
not follow it.
"""
