"""The yardstick's counts against hand-worked figures."""

from __future__ import annotations

import math
import statistics

import pytest
import torch

from benchmark import trace, yardstick
from benchmark.reference.nerf import NeRF


def test_macs_per_point_are_the_nerf_weights():
    m = NeRF()
    weights = sum(p.numel() for n, p in m.named_parameters() if n.endswith("weight"))
    biases = sum(p.numel() for n, p in m.named_parameters() if n.endswith("bias"))
    assert weights == yardstick.MAC_FWD == 593_408 and biases == yardstick.N_BIASES
    assert yardstick.MAC_TRAIN == 1_739_264


@pytest.mark.parametrize("rays, tflop", [(18_776, 12.540), (16_384, 10.942)])
def test_train_step_flops(rays, tflop):
    # 4 bundles (4,096 + 2 x 63x84 + 4,096 LLFF; 4 x 4,096 lego), 64 + 128 points
    assert yardstick.train_step_flops(rays, 64, 64) / 1e12 == pytest.approx(tflop, abs=1e-3)


def test_k3_bound_is_operations_bound():
    # 16,384 rays x 64 points, bf16: 2 x 593,408 x 16,384 x 64 / 989e12 s
    t, what = yardstick.k3_bound(16_384, 64, "bfloat16", backward=False)
    assert what == "operations" and t == pytest.approx(2 * 593_408 * 16_384 * 64 / 989e12)
    t, _ = yardstick.k3_bound(16_384, 64, "bfloat16", backward=True)
    assert t == pytest.approx(2 * (556_544 + 589_312) * 16_384 * 64 / 989e12)
    total = yardstick.k3_step_bound(16_384, 64, 64, "bfloat16")
    assert total == pytest.approx(2 * 1_739_264 * 16_384 * 192 / 989e12)


def test_k1_image_bound_sums_the_tiles():
    # 504 x 378 = 190,512 rays in tiles of 131,072 and 59,440, x 64 and x 128, f32
    t = yardstick.k1_image_bound(190_512, 131_072, 64, 64, "float32")
    assert t == pytest.approx(2 * 593_408 * 190_512 * 192 / 67e12, rel=1e-9)
    assert yardstick.image_flops(190_512, 64, 64) == pytest.approx(43.41e12, rel=1e-3)


def test_spread_is_the_quartile_distance_over_the_median():
    values = [100.0, 101.0, 102.0, 103.0, 104.0, 110.0]
    q1, med, q3 = statistics.quantiles(values, n=4)
    assert yardstick.spread(values) == pytest.approx((q3 - q1) / statistics.median(values))


def test_trace_reductions():
    tr = trace.Trace(ops=[("void nerf::k3::train_fwd_sm90<true>(float const*)", 100, 200),
                          ("void nerf::k3::train_bwd_sm90<0>(float const*)", 250, 450),
                          ("Memcpy HtoD", 440, 500)],
                     marks=[("window", 0, 1000), ("epoch", 0, 1000), ("step", 0, 240), ("flush", 600, 900)])
    assert trace.busy_seconds(tr, 0, 1000) == pytest.approx(350e-9)
    assert trace.op_seconds(tr, 0, 1000, ("train_fwd_sm90", "train_bwd_sm90")) == (pytest.approx(300e-9), 2)
    gaps = dict(trace.idle_gaps(tr, 0, 1000))
    # idle [0,100) and [200,250) start inside the step, [500,1000) in the epoch
    assert gaps["step"] == pytest.approx(150e-9) and gaps["epoch"] == pytest.approx(500e-9)
    assert trace.short_name(tr.ops[0][0]) == "nerf::k3::train_fwd_sm90"
    assert math.isclose(sum(v for _, v in trace.device_ops(tr, 0, 1000)), 360e-9)
