"""The benchmark's yardstick: the card's peaks, the NeRF's operations per
point, the kernels' bounds and the spread statistics.

The arithmetic is that of ``chip_smoke.py`` (``PEAK_FLOPS``,
``MAC_PER_POINT``, ``k1_bound``, ``k3_bound``), kept here so that the
program can change without moving the yardstick.  One departure: a training
backward counts the work it needs (dgrad and wgrad), not the forward that
the kernel recomputes.  Every count is the call's: its inputs and outputs
read or written once each, whatever the kernel reads again.
"""

from __future__ import annotations

import statistics
from typing import Dict, Sequence, Tuple

# H100 SXM published dense peaks (NVIDIA data sheet, at 700 W)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# multiply-adds per point of the reference NeRF (8x256 trunk with the skip,
# sigma head, 256 bottleneck, 128-wide direction branch, rgb head): one per
# weight, 593,408 weights
MAC_FWD = 593_408
MAC_DGRAD = 556_544  # the input gradients of every product but the first layer's
MAC_WGRAD = 589_312  # the weight gradients (the direction block once per ray)
MAC_TRAIN = MAC_FWD + MAC_DGRAD + MAC_WGRAD  # 1,739,264 a training point
N_WEIGHTS, N_BIASES = 593_408, 2_436
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def _bound(flops: float, nbytes: float, dtype: str) -> Tuple[float, str]:
    """(seconds, what bounds it): the larger of operations over the peak and
    bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _weight_bytes(dtype: str) -> int:
    return N_WEIGHTS * DTYPE_BYTES[dtype] + N_BIASES * 4


def k1_bound(n: int, s: int, dtype: str) -> Tuple[float, str]:
    """K1, the render of one level of n rays x s samples: rays and depths
    in, weights in, rgb, depth and per-sample weights out."""
    flops = 2.0 * MAC_FWD * n * s
    nbytes = n * 6 * 4 + n * s * 4 + _weight_bytes(dtype) + n * 3 * 4 + n * 4 + n * s * 4
    return _bound(flops, nbytes, dtype)


def k3_bound(n: int, s: int, dtype: str, backward: bool) -> Tuple[float, str]:
    """K3, the training render of one level of n rays x s samples.  The
    forward reads rays, depths, noise and weights and writes rgb, depth,
    opacity and its residuals (weights, alphas, per-sample rgb); the
    backward reads those and the three cotangents and writes the weight
    and bias gradients in float32."""
    ray_in = n * 6 * 4 + 2 * n * s * 4
    residuals = 2 * n * s * 4 + n * s * 3 * 4
    if backward:
        flops = 2.0 * (MAC_DGRAD + MAC_WGRAD) * n * s
        nbytes = ray_in + residuals + _weight_bytes(dtype) + n * 4 * 4 + n * s * 4 + (N_WEIGHTS + N_BIASES) * 4
    else:
        flops = 2.0 * MAC_FWD * n * s
        nbytes = ray_in + _weight_bytes(dtype) + n * 4 * 4 + residuals
    return _bound(flops, nbytes, dtype)


def train_step_flops(rays: int, n_samples: int, n_importance: int) -> float:
    """The NeRF's model FLOPs of one training step: forward, dgrad and wgrad
    at every point of both levels (the ViT and D are not counted)."""
    return 2.0 * MAC_TRAIN * rays * (2 * n_samples + n_importance)


def image_flops(rays: int, n_samples: int, n_importance: int) -> float:
    """The NeRF's forward FLOPs of one whole-image render, both levels."""
    return 2.0 * MAC_FWD * rays * (2 * n_samples + n_importance)


def k3_step_bound(rays: int, n_samples: int, n_importance: int, dtype: str) -> float:
    """Seconds: the bound of one step's four K3 calls (both levels, forward
    and backward)."""
    fine = n_samples + n_importance
    return sum(k3_bound(rays, s, dtype, bwd)[0] for s in (n_samples, fine) for bwd in (False, True))


def k1_image_bound(rays: int, tile: int, n_samples: int, n_importance: int, dtype: str) -> float:
    """Seconds: the bound of one image's K1 calls, both levels of each tile
    of ``tile`` rays (the last one shorter)."""
    total = 0.0
    for start in range(0, rays, tile):
        n = min(tile, rays - start)
        total += k1_bound(n, n_samples, dtype)[0] + k1_bound(n, n_samples + n_importance, dtype)[0]
    return total


def spread(values: Sequence[float]) -> float:
    """The distance between the first and the third quartile
    (``statistics.quantiles``, n=4) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def summary(values: Sequence[float]) -> Dict[str, float]:
    return {"median": statistics.median(values), "spread": spread(values), "n": len(values)}
