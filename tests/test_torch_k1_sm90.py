"""The Hopper K1 kernels' layouts and launch plan on the CPU, and on the card
the kernels themselves against their plain version.

K1 (``ops/fused_render.py::fused_render_level``) runs
``csrc/fused_render_sm90.cu`` on a CUDA tensor: in bf16 the K3-fwd kernel
without noise and residuals on the ``wgmma`` body (its slab layout is pinned
by ``tests/test_torch_k3_sm90.py``), in float32 an FFMA kernel that streams
the weights as K-major slabs by bulk copies (``sm90_layout.slab_buffer_f32``).
A value in the wrong place gives sums that are finite and plausible, so the
CPU tests pin the float32 slab bytes, the order the kernel consumes them in
and a round trip to ``pack_weights``' layout bit for bit; they hold the
kernel's register tiles (a Python mirror of ``mlp_f32_sm90.cuh``'s Map and
at()) to cover each layer once without shared-memory bank conflicts, and the
launch plan to cover every ray once within the shared-memory limit.

Tests marked ``cuda`` build and launch the kernels and skip without a card:
both dtypes against the plain version at ragged shapes under
``chip_smoke.py``'s K1 limits, and K1 bf16 bit-equal to K3-fwd bf16 without
noise.  The file imports no JAX."""

import math
import os
import sys

import numpy as np
import pytest
import torch

from sinnerf_tpu_torch.core.composite import intervals, ray_norm
from sinnerf_tpu_torch.models.nerf import nerf_from_state, random_params, state_dict_from_jax
from sinnerf_tpu_torch.ops import fused_render as fr
from sinnerf_tpu_torch.ops import fused_render_train as frt
from sinnerf_tpu_torch.ops import sm90_layout as L
from sinnerf_tpu_torch.ops.fused_mlp import WEIGHT_OFFSETS, WEIGHT_SIZE, pack_weights

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

RAY_COUNTS = (1, 127, 128, 129, 1000, 5292)
EVAL_RAYS = (131_072, 59_440)  # one 504x378 image in tiles of 131,072 rays
SAMPLE_COUNTS = (1, 9, 12, 64, 192)
H100_SMS = 132
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on an H100


@pytest.fixture(scope="module")
def model():
    return nerf_from_state(state_dict_from_jax(random_params(np.random.default_rng(8))))


@pytest.fixture(scope="module")
def packed_f32(model):
    return pack_weights(model, torch.float32)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def test_f32_slab_buffer_round_trips_bit_for_bit(packed_f32):
    buf = L.slab_buffer_f32(packed_f32)
    assert buf.dtype == torch.float32 and buf.shape == (L.SLAB_BUFFER_F32_SIZE,) == (WEIGHT_SIZE,)
    assert torch.equal(_bits(L.unpack_slab_buffer_f32(buf)), _bits(packed_f32.w))
    # a permutation of the packed weights: nothing dropped, nothing padded
    assert torch.equal(torch.sort(_bits(buf)).values, torch.sort(_bits(packed_f32.w)).values)


@pytest.mark.parametrize("block", L.FWD_BLOCKS)
def test_f32_slab_byte_order_is_the_kernels(packed_f32, block):
    """Element (row k0 + kk, output o) of a slab lies at byte 4 (kk out + o)
    from its start, which sits on a 16-byte boundary, as the kernel's bulk
    copies and float4 loads need."""
    raw = L.slab_buffer_f32(packed_f32).view(torch.uint8)
    off, (rows, cols) = WEIGHT_OFFSETS[block]
    weights = packed_f32.w[off : off + rows * cols].view(rows, cols)
    slabs = [(s, start) for s, start in zip(L.F32_SLABS, L.F32_SLAB_OFFSETS) if s.block == block]
    assert [s.k0 for s, _ in slabs] == list(range(0, cols, L.F32_ROWS))
    for s, start in slabs:
        assert start % 16 == 0 and s.nbytes % 16 == 0 and s.out == rows
        kk = torch.arange(L.F32_ROWS)[:, None]
        o = torch.arange(rows)[None, :]
        byte = start + 4 * (kk * rows + o)
        got = torch.stack([raw[byte + i] for i in range(4)], -1).view(torch.int32)[..., 0]  # little-endian
        assert torch.equal(got, _bits(weights[:, s.k0 : s.k0 + L.F32_ROWS].T.contiguous()))


def test_f32_slab_order_matches_the_kernel():
    """csrc/mlp_f32_sm90.cuh: 136 slabs of 256 outputs, then 18 of 128, at
    slab_offset(i); the heads after them at HEAD_OFF = 2,375,680 bytes."""
    blocks = (["w1"] * 4 + ["w2"] * 16 + ["w3"] * 16 + ["w4"] * 16 + ["w5h"] * 16 + ["w5x"] * 4 + ["w6"] * 16
              + ["w7"] * 16 + ["w8"] * 16 + ["wfin"] * 16 + ["wdh"] * 16 + ["wdx"] * 2)
    assert [s.block for s in L.F32_SLABS] == blocks
    assert [s.out for s in L.F32_SLABS] == [256] * 136 + [128] * 18
    assert L.F32_SLAB_OFFSETS == [i * 16384 if i < 136 else 136 * 16384 + (i - 136) * 8192 for i in range(154)]
    assert L.F32_HEAD_OFFSET == 2_375_680 and L.SLAB_BUFFER_F32_SIZE == L.F32_HEAD_OFFSET // 4 + 3 * 128 + 256


def test_f32_slab_buffer_takes_float32_only(model):
    with pytest.raises(ValueError):
        L.slab_buffer_f32(pack_weights(model, torch.bfloat16))
    with pytest.raises(ValueError):
        L.unpack_slab_buffer_f32(torch.zeros(10))


def test_f32_shared_memory_arithmetic():
    """The source note's budget: activations 131,072, PE 32,768, ring
    3 x 16,384, rays, head partials and barriers 7,232."""
    assert L.K1_F32_SMEM == 131_072 + 32_768 + 3 * 16_384 + 7_232 == 220_224 <= SMEM_LIMIT
    assert L.FWD_SMEM <= SMEM_LIMIT


@pytest.mark.parametrize("n", RAY_COUNTS + EVAL_RAYS)
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_k1_launch_plan(n, compute_dtype):
    for s in SAMPLE_COUNTS:
        plan = L.k1_launch_plan(n, s, H100_SMS, compute_dtype)
        tiles = math.ceil(n / 128)
        assert plan["tiles"] == tiles and plan["ctas"] == min(tiles, H100_SMS)
        assert plan["threads"] == 384
        assert plan["smem"] <= SMEM_LIMIT
        # the persistent walk (tile = blockIdx + k * ctas) covers every ray once
        cover = np.zeros(tiles * 128, dtype=int)
        per_cta = [0] * plan["ctas"]
        for cta in range(plan["ctas"]):
            for tile in range(cta, tiles, plan["ctas"]):
                cover[tile * 128 : (tile + 1) * 128] += 1
                per_cta[cta] += 1
        assert (cover[:n] == 1).all() and max(per_cta) == plan["tiles_per_cta"]
        assert plan["slabs_per_cta"] == max(per_cta) * s * (39 if compute_dtype == "bfloat16" else 154)


def test_k1_launch_plan_refuses_other_dtypes():
    with pytest.raises(ValueError):
        L.k1_launch_plan(128, 64, H100_SMS, "float16")


# A Python mirror of csrc/mlp_f32_sm90.cuh's thread map: consumer thread t
# (warp w, lane l) holds points 32 (w % 4) + 16 i + 4 (l // 8) + e and outputs
# (O // 2) (w // 4) + 32 j + 4 (l % 8) + e; at() places (row k, point p) of a
# [k][point] tile at k * 128 + (p ^ ((k & 4) << 2)).
def _at(k, p):
    return k * 128 + (p ^ ((k & 4) << 2))


def _points(t):
    w, lane = divmod(t, 32)
    return [32 * (w % 4) + 16 * i + 4 * (lane // 8) + e for i in range(2) for e in range(4)]


def _outputs(t, o):
    w, lane = divmod(t, 32)
    return [(o // 2) * (w // 4) + 32 * j + 4 * (lane % 8) + e for j in range(o // 64) for e in range(4)]


@pytest.mark.parametrize("width", [256, 128])
def test_register_tiles_cover_a_layer_once(width):
    hits = np.zeros((128, width), dtype=int)
    for t in range(256):
        for p in _points(t):
            hits[p, _outputs(t, width)] += 1
    assert (hits == 1).all()


def _wavefronts(chunks):
    """Shared-memory wavefronts of one warp-wide 16-byte access: distinct
    16-byte chunks are served 8 per wavefront (32 banks), those in the same
    bank group (chunk % 8) in separate ones; equal chunks are one broadcast."""
    per_group = np.bincount([c % 8 for c in set(chunks)], minlength=8)
    return int(per_group.max())


@pytest.mark.parametrize("width", [256, 128])
def test_lane_map_is_free_of_bank_conflicts(width):
    """Per k step, each of a warp's float4 loads (2 of activations, width / 64
    of weights) takes one wavefront; each of the epilogue's float4 stores of
    32 distinct chunks takes the least, four."""
    for w in range(8):
        lanes = range(32 * w, 32 * w + 32)
        for k in range(16):
            for i in range(2):  # activations: row k, the thread's i-th point group
                assert _wavefronts([_at(k, _points(t)[4 * i]) // 4 for t in lanes]) == 1
            for j in range(width // 64):  # weights: slab row k, output group j
                assert _wavefronts([(k * width + _outputs(t, width)[4 * j]) // 4 for t in lanes]) == 1
        if width == 256:
            for j in range(4):
                for e in range(4):
                    for i in range(2):  # epilogue store of output 4j + e, point group i
                        chunks = [_at(_outputs(t, width)[4 * j + e], _points(t)[4 * i]) // 4 for t in lanes]
                        assert len(set(chunks)) == 32 and _wavefronts(chunks) == 4
    # the swizzle keeps a thread's point groups whole float4s
    for k in range(8):
        for p0 in range(0, 128, 4):
            assert [_at(k, p0 + e) for e in range(4)] == list(range(_at(k, p0), _at(k, p0) + 4))


def test_cpu_tensors_run_the_plain_version_and_count_no_launch(model):
    rng = np.random.default_rng(3)
    rays, z = chip_smoke.make_rays(rng, 50, 9, torch.device("cpu"))
    before = fr.fused_render_level.launches, fr.launch_render_block64.launches, frt.launch_train_fwd.launches
    for cd in ("float32", "bfloat16"):
        got = fr.fused_render_level(model, rays, z, True, True, cd)
        want = fr.render_level_plain(model, rays, z, True, True, cd)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert (fr.fused_render_level.launches, fr.launch_render_block64.launches,
            frt.launch_train_fwd.launches) == before


def test_one_sample_plain_render_keeps_its_weight(model):
    """At S = 1 the only interval is 1e10 ||d||, as the kernels take it: the
    plain version returns one weight per ray (it returned none before)."""
    rays, z = chip_smoke.make_rays(np.random.default_rng(5), 7, 1, torch.device("cpu"))
    d = rays[:, 3:6]
    assert torch.equal(intervals(z, d), torch.full_like(z, 1e10) * ray_norm(d))
    rgb, depth, w = fr.render_level_plain(model, rays, z, True, False, "float32")
    assert w.shape == (7, 1) and rgb.shape == (7, 3) and depth.shape == (7,)
    assert torch.equal(depth, w[:, 0] * z[:, 0])


@pytest.mark.parametrize("capability", [(8, 0), (8, 9), (9, 1), (10, 0)])
def test_the_hopper_kernels_refuse_other_cards(capability):
    with pytest.raises(RuntimeError):
        fr.require_sm90(capability)
    fr.require_sm90((9, 0))


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", RAY_COUNTS)
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_k1_matches_plain_at_ragged_shapes(cuda_device, n, compute_dtype):
    """K1 against its plain version at n rays x every S of SAMPLE_COUNTS,
    white background on and off, under chip_smoke.py's K1 limits; one launch
    each.  At one ray in bf16 the mean is that of a few elements, so there it
    is held over chip_smoke.K1_SINGLE_RAYS single-ray launches instead."""
    rng = np.random.default_rng(n)
    model = chip_smoke.make_model(1, cuda_device)
    tol = chip_smoke.K1_TOL[compute_dtype]
    for s in SAMPLE_COUNTS:
        for white_back in (False, True):
            rays, z = chip_smoke.make_rays(rng, n, s, cuda_device)
            before = fr.fused_render_level.launches
            got = fr.fused_render_level(model, rays, z, True, white_back, compute_dtype)
            torch.cuda.synchronize()
            assert fr.fused_render_level.launches == before + 1
            err = chip_smoke.k1_error(got, fr.render_level_plain(model, rays, z, True, white_back, compute_dtype))
            print(f"{compute_dtype} n={n} S={s} white_back={int(white_back)}: {err}")
            assert err[0] <= tol[0], (s, white_back, err)
            assert (n == 1 and compute_dtype == "bfloat16") or err[1] <= tol[1], (s, white_back, err)
    if n == 1 and compute_dtype == "bfloat16":
        means = chip_smoke.k1_single_ray_means(model, cuda_device, rng)
        print(f"n=1, mean over {chip_smoke.K1_SINGLE_RAYS} launches: {means}")
        assert max(means) <= tol[1], means


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 129, 1000])
def test_k1_bf16_equals_k3_fwd_without_noise(cuda_device, n):
    """One kernel template: K1 bf16 and K3-fwd bf16 with no noise give the
    same rgb, depth and weights, bit for bit."""
    rng = np.random.default_rng(100 + n)
    packed = pack_weights(chip_smoke.make_model(2, cuda_device), torch.bfloat16)
    for s, white_back in ((9, False), (64, True), (192, False)):
        rays, z = chip_smoke.make_rays(rng, n, s, cuda_device)
        k1 = fr.launch_render(packed, rays, z, True, white_back)
        k3 = frt.launch_train_fwd(packed, rays, z, None, True, white_back)
        for a, b in zip(k1, k3[:3]):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (s, white_back)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_earlier_k1_matches_plain(cuda_device, compute_dtype):
    """The earlier kernel, kept for the timing rounds, still holds."""
    rng = np.random.default_rng(7)
    model = chip_smoke.make_model(1, cuda_device)
    packed = pack_weights(model, torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32)
    rays, z = chip_smoke.make_rays(rng, 1000, 12, cuda_device)
    before = fr.launch_render_block64.launches
    got = fr.launch_render_block64(packed, rays, z, True, True)
    torch.cuda.synchronize()
    assert fr.launch_render_block64.launches == before + 1
    err = chip_smoke.k1_error(got, fr.render_level_plain(model, rays, z, True, True, compute_dtype))
    tol = chip_smoke.K1_TOL[compute_dtype]
    assert err[0] <= tol[0] and err[1] <= tol[1], err
