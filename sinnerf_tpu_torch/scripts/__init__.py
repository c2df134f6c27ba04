"""The port's scripts, named after the JAX package's ``scripts/``: the
kernel experiments (``exp_kernel_variants``, ``exp_bwd_pipeline``) and what
they share, the full-recipe soak and its status tool (``soak``,
``soak_status``), the convergence demo, ``step_times`` and
``compare_builds``."""

from typing import Dict, List, Sequence, Tuple

PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet, 700 W)


def ratios(per_round: Dict[str, List[float]], ref: str) -> Dict[str, List[float]]:
    """Per name, its time over ``ref``'s in each round of ``interleaved_ms``."""
    return {name: [t / r for t, r in zip(ts, per_round[ref])] for name, ts in per_round.items()}


def mean_range(xs: Sequence[float]) -> Tuple[float, Tuple[float, float]]:
    """The mean of per-round ratios and their (min, max)."""
    return sum(xs) / len(xs), (min(xs), max(xs))
