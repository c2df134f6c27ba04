"""The benchmark of ``sinnerf_tpu_torch``: ``python3 -m benchmark.run``.

Cells, configurations, traffic mixes, limits and per-layer metrics are
files found by the names in ``BENCHMARK.json`` (``benchmark/spec.py``).
Nothing here imports ``jax`` or ``sinnerf_tpu``; ``benchmark/reference``
imports nothing of ``sinnerf_tpu_torch`` either.
"""
