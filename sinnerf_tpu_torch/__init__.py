"""PyTorch/CUDA port of ``sinnerf_tpu``: the eval render path, the training
render and step, and the train CLI on the LLFF training set.

The package mirrors ``sinnerf_tpu``'s layout (``core``, ``models``, ``ops``,
``render``, ``data``, ``train``, ``utils``) so each module's counterpart is
found under the same name.  It imports neither ``jax`` nor ``sinnerf_tpu``.
The hand-written CUDA kernels live in ``csrc/`` and are built with ``nvcc``
at first use (``ops/_build.py``).
"""
