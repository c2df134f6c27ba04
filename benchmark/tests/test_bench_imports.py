"""The whole-name check of JAX's modules, and a reference that imports
nothing of the program."""

from __future__ import annotations

import subprocess
import sys

from benchmark.run import forbidden_modules
from benchmark.spec import ROOT


def test_whole_top_level_names():
    assert forbidden_modules(["sinnerf_tpu", "sinnerf_tpu.ops.fused_mlp_t", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "sinnerf_tpu", "sinnerf_tpu.ops.fused_mlp_t"]
    assert forbidden_modules(["sinnerf_tpu_torch", "sinnerf_tpu_torch.train.loop", "jaxtyping", "flaxen",
                              "torch", "benchmark.run"]) == []


def test_reference_imports_nothing_of_the_program_or_jax():
    code = ("import sys, benchmark.reference.step, benchmark.reference.scene, benchmark.draws, benchmark.judge, "
            "benchmark.yardstick, benchmark.trace; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'sinnerf_tpu_torch', 'sinnerf_tpu', 'jax', "
            "'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
