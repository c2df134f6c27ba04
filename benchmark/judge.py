"""The numbers that decide ``correct``, each compared with its limit.

A training step is judged by three numbers against the reference's:
``loss_gap``, the largest relative gap of a checked step's loss;
``grad_gap``, the worst leaf's gap between the norms of the first gradient
(the program's read from Adam's first moment after one step); and
``change_gap``, the worst leaf's gap between the norms of the parameters'
change over the checked steps.  A leaf's gap is measured against the
reference's norm of that leaf or of the median leaf, whichever is larger.
Leaves whose first reference gradient is under a thousandth of the median
leaf's are left out of both: Adam moves them by round-off alone.

An image is judged by ``rgb_gap``, the largest absolute gap of the fine
level's colour over the checked images.  Its depth is not compared: the
reference one step below float32 (TF32) moves it less than the program's
own rounding does (PERF.md), so no limit would separate the two.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

import torch

GRAD_FLOOR = 1e-3  # a leaf's first gradient under this share of the median leaf's is left out


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def counted_leaves(ref_grads: Dict[str, torch.Tensor]) -> List[str]:
    norms = _norms(ref_grads)
    med = statistics.median(norms.values())
    return sorted(k for k, v in norms.items() if v >= GRAD_FLOOR * med)


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], leaves: Sequence[str]) -> Dict[str, float]:
    """Per leaf, ``|‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖)``."""
    p, r = _norms({k: prog[k] for k in leaves}), _norms({k: ref[k] for k in leaves})
    med = statistics.median(r.values())
    return {k: abs(p[k] - r[k]) / max(r[k], med) for k in leaves}


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], leaves: Sequence[str]) -> float:
    """The worst leaf's gap."""
    gaps = list(leaf_gaps(prog, ref, leaves).values())
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog, ref)]
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``losses`` (per checked step), ``grads`` (the
    first step's, per leaf) and ``change`` (per leaf, over the checked
    steps)."""
    leaves = counted_leaves(ref["grads"])
    return {
        "loss_gap": loss_gap(prog["losses"], ref["losses"]),
        "grad_gap": leaf_gap(prog["grads"], ref["grads"], leaves),
        "change_gap": leaf_gap(prog["change"], ref["change"], leaves),
    }


def image_numbers(prog: Sequence[Dict[str, torch.Tensor]], ref: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    def worst(key):
        gaps = [float(torch.max(torch.abs(p[key].double() - r[key].double()))) for p, r in zip(prog, ref)]
        return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf

    return {"rgb_gap": worst("rgb_fine")}


def compared(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, float]:
    """The numbers the cell's limits file gives a limit: the ones that
    separate the program from its control and faults in that cell."""
    missing = set(limits) - set(numbers)
    if missing or not limits:
        raise KeyError(f"limits for numbers the cell does not compute: {sorted(missing)}")
    return {k: v for k, v in numbers.items() if k in limits}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every compared number finite and within its limit."""
    return all(math.isfinite(v) and v <= limits[k] for k, v in compared(numbers, limits).items())


def lines(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit, for the result line and
    standard error."""
    return {k: {"value": v, "limit": limits[k]} for k, v in compared(numbers, limits).items()}
