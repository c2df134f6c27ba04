"""The Hopper K3 kernels' layouts and launch plan on the CPU, and on the card
the kernels themselves against their plain versions.

``ops/sm90_layout.py`` lays the weights out for the kernels' bulk copies and
``wgmma`` descriptors (``csrc/fused_render_train_sm90.cu``).  A byte in the
wrong place gives sums that are finite and plausible, so the CPU tests pin the
byte order the descriptors assume: the 128-byte swizzle, 1,024-byte
alignment, the slab order of both directions, and a round trip to
``pack_weights``' layout bit for bit.  The launch plan's tiles, CTAs, slabs
and scratch are held at ragged ray counts and at the train batches' counts,
and the backward's walk over (ray tile, sample range) units is played out:
every (ray, sample) once, no split where the tiles fit on the SMs.

Tests marked ``cuda`` build and launch the kernels and skip without a card:
the descriptor probe against a plain product, and K3-fwd / K3-bwd in bf16
against their plain versions under ``chip_smoke.py``'s K3 limits, the
backward also split into sample ranges."""

import math
import os
import sys

import numpy as np
import pytest
import torch

from sinnerf_tpu_torch.models.nerf import nerf_from_state, random_params, state_dict_from_jax
from sinnerf_tpu_torch.ops import fused_render_train as frt
from sinnerf_tpu_torch.ops import sm90_layout as L
from sinnerf_tpu_torch.ops.fused_mlp import WEIGHT_OFFSETS, WEIGHT_SIZE, pack_weights, unpack_grads

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

RAY_COUNTS = (1, 63, 64, 65, 127, 128, 129, 333, 1000, 5292)
PATH_RAY_COUNTS = (16384, 16032, 18776, 20480)  # the train batches of lego, DTU, LLFF and Blender proj
SAMPLE_COUNTS = (9, 12, 64, 192)
H100_SMS = 132
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on an H100


@pytest.fixture(scope="module")
def packed():
    model = nerf_from_state(state_dict_from_jax(random_params(np.random.default_rng(7))))
    return pack_weights(model, torch.bfloat16)


@pytest.fixture(scope="module")
def slabs(packed):
    return L.slab_buffer(packed)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16)


def test_slab_buffer_round_trips_bit_for_bit(packed, slabs):
    assert slabs.dtype == torch.bfloat16 and slabs.shape == (L.SLAB_BUFFER_SIZE,)
    assert torch.equal(_bits(L.unpack_slab_buffer(slabs)), _bits(packed.w))
    assert L.HEAD_OFFSET == 1_196_032 and L.SLAB_BUFFER_SIZE * 2 == L.HEAD_OFFSET + 2 * (3 * 128 + 256)


@pytest.mark.parametrize("index", range(len(L.FWD_SLABS)))
def test_slab_byte_order_is_the_descriptors(packed, slabs, index):
    """Element (row r, column k0 + c) of a slab lies at byte r * 128 +
    ((c // 8) ^ (r % 8)) * 16 + (c % 8) * 2 from its start, which sits on a
    1,024-byte boundary; columns past the block's are zero."""
    s = L.FWD_SLABS[index]
    start = L.SLAB_OFFSETS[index]
    assert start % 1024 == 0 and s.nbytes % 1024 == 0
    raw = slabs.view(torch.uint8)[start : start + s.nbytes]
    off, (rows, cols) = WEIGHT_OFFSETS[s.block]
    block = packed.w[off : off + rows * cols].view(rows, cols)
    r = torch.arange(rows)[:, None]
    c = torch.arange(L.SW)[None, :]
    byte = r * 128 + ((c // 8) ^ (r % 8)) * 16 + (c % 8) * 2
    got = torch.stack([raw[byte], raw[byte + 1]], -1).view(torch.int16)[..., 0]  # little-endian bf16
    want = torch.zeros(rows, L.SW, dtype=torch.bfloat16)
    width = min(L.SW, cols - s.k0)
    want[:, :width] = block[:, s.k0 : s.k0 + width]
    assert torch.equal(got, _bits(want))


def test_slab_orders_match_the_kernels():
    """FWD_SLABS: the forward's products in order (34 slabs of 256 rows, then
    5 of 128); BWD_SLABS: csrc/mlp_wgmma.cuh's bwd_slab(j) = first[j // 4] +
    j % 4."""
    assert [s.block for s in L.FWD_SLABS] == (["w1"] + ["w2"] * 4 + ["w3"] * 4 + ["w4"] * 4 + ["w5h"] * 4 + ["w5x"]
                                              + ["w6"] * 4 + ["w7"] * 4 + ["w8"] * 4 + ["wfin"] * 4 + ["wdh"] * 4
                                              + ["wdx"])
    assert [s.rows for s in L.FWD_SLABS] == [256] * 34 + [128] * 5
    first = [34, 30, 26, 22, 18, 13, 9, 5, 1]
    assert list(L.BWD_SLABS) == [first[j // 4] + j % 4 for j in range(36)]
    offs = [i * 32768 if i < 34 else 34 * 32768 + (i - 34) * 16384 for i in range(39)]
    assert L.SLAB_OFFSETS == offs


def test_swizzle_is_a_permutation_and_act_offset_agrees():
    tile = torch.arange(128 * 64, dtype=torch.int32).view(128, 64)
    img = L.swizzle(tile)
    assert torch.equal(torch.sort(img).values, tile.reshape(-1)) and torch.equal(L.unswizzle(img, 128), tile)
    for p, k in ((0, 0), (1, 8), (7, 63), (9, 130), (127, 255), (64, 200)):
        block, col = divmod(k, 64)
        assert L.act_offset(p, k) == block * L.ACT_BLOCK + 2 * int((img == tile[p, col]).nonzero()[0, 0])


def test_slab_buffer_refuses_float32(packed):
    with pytest.raises(ValueError):
        L.slab_buffer(type(packed)(packed.w.float(), packed.b))


@pytest.mark.parametrize("n", RAY_COUNTS + PATH_RAY_COUNTS)
def test_launch_plan(n):
    for s in SAMPLE_COUNTS + (128,):
        plan = L.launch_plan(n, s, H100_SMS)
        tiles = math.ceil(n / 128)
        assert plan["tiles"] == tiles and plan["ctas"] == min(tiles, H100_SMS) and plan["threads"] == 384
        # the forward's persistent walk (tile = blockIdx + k * ctas) covers every ray once
        cover = np.zeros(tiles * 128, dtype=int)
        per_cta = [0] * plan["ctas"]
        for cta in range(plan["ctas"]):
            for tile in range(cta, tiles, plan["ctas"]):
                cover[tile * 128 : (tile + 1) * 128] += 1
                per_cta[cta] += 1
        assert (cover[:n] == 1).all() and max(per_cta) == plan["tiles_per_cta"]
        assert plan["fwd_slabs_per_cta"] == max(per_cta) * s * 39
        # the backward's walk (unit = blockIdx + k * ctas: tile unit // chunks,
        # samples [span (unit % chunks), + span)) covers every (ray, sample) once
        chunks = plan["chunks"]
        span = s // chunks
        assert span * chunks == s and plan["units"] == tiles * chunks
        if tiles <= H100_SMS:
            assert chunks == 1
        cover = np.zeros((tiles * 128, s), dtype=int)
        passes, units = [0] * plan["ctas"], [0] * plan["ctas"]
        for cta in range(plan["ctas"]):
            for unit in range(cta, plan["units"], plan["ctas"]):
                tile, s0 = divmod(unit, chunks)
                cover[tile * 128 : (tile + 1) * 128, s0 * span : (s0 + 1) * span] += 1
                passes[cta] += span
                units[cta] += 1
        assert (cover[:n] == 1).all()
        assert max(units) == plan["bwd_units_per_cta"] and max(passes) == plan["bwd_passes_per_cta"]
        assert plan["bwd_slabs_per_cta"] == max(passes) * 75
        if n == 18776 and s in (64, 128):  # LLFF's 147 tiles: no second wave of whole tiles
            assert chunks > 1 and max(passes) <= 0.6 * 2 * s
        assert plan["fwd_smem"] <= SMEM_LIMIT and plan["bwd_smem"] <= SMEM_LIMIT
        assert plan["scratch_bytes"] == plan["ctas"] * (9 * 65536 + 128 * 128 * 4)


def test_flush_lanes_cover_every_sum_once():
    """The backward's vector flush (mlp_backward_wgmma.cuh::flush): each
    thread of a warpgroup holds rows 16w + l/4 (+8) and columns 8j + 2(l % 4)
    (+1) of a 64 x N accumulator tile; lanes swap halves with lane ^ 1 and
    each adds four neighbouring columns of one row, 16-byte aligned."""
    n = 256
    hits = np.zeros((64, n), dtype=int)
    for t in range(128):
        w, lane = divmod(t, 32)
        r0, q = 16 * w + lane // 4, lane % 4
        for j in range(n // 8):
            c = 8 * j + 2 * q
            row, col = (r0, c) if q % 2 == 0 else (r0 + 8, c - 2)
            assert col % 4 == 0
            hits[row, col : col + 4] += 1
    assert (hits == 1).all()


def test_the_port_imports_no_jax_in_the_new_module():
    src = open(os.path.join(os.path.dirname(L.__file__), "sm90_layout.py")).read()
    assert "import jax" not in src and "sinnerf_tpu." not in src


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
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_probe_matches_a_plain_product(cuda_device, mode):
    """The descriptors (K-major and MN-major, N = 64 and 256), the swizzle
    and the vector flush against a float32 product of the same bf16 values."""
    rng = np.random.default_rng(mode)

    def bf(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32).to(torch.bfloat16).to(cuda_device)

    a, c, w = bf(128, 256), bf(128, 256), bf(256, 64)
    got = frt.sm90_probe(mode, a, c, L.swizzle(w))
    torch.cuda.synchronize()
    want = frt.sm90_probe_plain(mode, a, c, w)
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err < 1e-5, (mode, err)


SINGLE_RAYS = 64
CASES = ((9, False, True), (12, True, False))  # (S, white background, noise)
LLFF_CASES = ((64, False, True), (128, False, True))  # the LLFF cell's levels
# (n, SMs the plan is told of (None: the card's), cases, whether K3-bwd cuts
# its tiles into sample ranges): the ragged counts, then the split path on a
# few SMs at ragged counts, at LLFF's 18,776 rays, and lego's 16,384 unsplit
MATCH_CASES = ([(n, None, CASES, False) for n in RAY_COUNTS]
               + [(1000, 3, CASES, True), (5292, 8, CASES, True), (18776, None, LLFF_CASES, True),
                  (16384, None, LLFF_CASES, False)])


@pytest.mark.cuda
@pytest.mark.parametrize("n, sms, cases, split", MATCH_CASES,
                         ids=[f"{c[0]}" + (f"-sms{c[1]}" if c[1] else "") for c in MATCH_CASES])
def test_sm90_kernels_match_plain(cuda_device, monkeypatch, n, sms, cases, split):
    """K3-fwd and K3-bwd in bf16 against their plain versions at n rays x
    S = 9 (noise) and 12 (white background), or the LLFF cell's 64 and 128
    (noise), on each kernel's own residuals as ``chip_smoke.k3_check`` chains
    them, under ``chip_smoke.py``'s K3 limits per shape: the forward's
    largest and mean error (outputs and residuals) and the backward's worst
    leaf.  With ``sms`` the launch plan is told of that many SMs, so that
    the backward cuts its tiles into sample ranges; each launch adds to
    ``launch_train_bwd.split_launches`` exactly when ``split``.  At one ray
    the mean is that of one ray's ~50 elements, so one rounding that the
    kernel and the plain version take apart decides it: there the mean limit
    holds over SINGLE_RAYS launches of one ray each, every one a tile with
    127 empty rows.  The earlier (wmma) forward's errors on the same inputs
    are printed beside the new ones."""
    if sms is not None:
        monkeypatch.setattr(frt, "_sm_count", lambda dev: sms)
    for s, _, _ in cases:
        assert (L.launch_plan(n, s, frt._sm_count(cuda_device))["chunks"] > 1) == split, (n, s)
    fwd_tol, bwd_tol = chip_smoke.K3_FWD_TOL["bfloat16"], chip_smoke.K3_BWD_TOL["bfloat16"]
    for case, err_f, err_earlier, err_b in _ragged_errors(cuda_device, n, cases, split):
        print(f"n={n} {case}: fwd {err_f}, earlier fwd {err_earlier}, bwd {err_b}")
        assert err_f[0] <= fwd_tol[0], (n, case, err_f)
        assert n == 1 or err_f[1] <= fwd_tol[1], (n, case, err_f)
        assert err_b[0] <= bwd_tol[0] and err_b[1] <= bwd_tol[1], (n, case, err_b)
    if n == 1:
        means = _single_ray_means(cuda_device)
        print(f"n=1, mean over {SINGLE_RAYS} launches: {means}")
        assert max(means) <= fwd_tol[1], means


def _case_inputs(rng, device, n, s, use_noise):
    rays, z = chip_smoke.make_rays(rng, n, s, device)
    noise = torch.tensor(rng.normal(size=(n, s)), dtype=torch.float32, device=device) if use_noise else None
    return rays, z, noise


def _ragged_errors(device, n, cases=CASES, split=False):
    """Per (S, flags) case at n rays: the new forward's (largest, mean)
    error, the earlier forward's on the same inputs, and the backward's
    worst leaf; each backward launch counted as split when ``split``."""
    rng = np.random.default_rng(n)
    packed = pack_weights(chip_smoke.make_model(2, device), torch.bfloat16)
    errs = []
    for s, white_back, use_noise in cases:
        rays, z, noise = _case_inputs(rng, device, n, s, use_noise)
        target = torch.tensor(rng.uniform(size=(n, 3)), dtype=torch.float32, device=device)
        before = frt.launch_train_fwd.launches, frt.launch_train_bwd.launches
        split_before = frt.launch_train_bwd.split_launches
        out = frt.launch_train_fwd(packed, rays, z, noise, True, white_back)
        ref = frt.render_level_train_forward_plain(packed, rays, z, noise, True, white_back)
        earlier = frt.launch_train_fwd_block64(packed, rays, z, noise, True, white_back)
        args = (packed, rays, z, noise, out[2], out[3], out[4], *chip_smoke.cotangents(out, target), True, white_back)
        got = unpack_grads(*frt.launch_train_bwd(*args))
        want = unpack_grads(*frt.render_level_train_backward_plain(*args))
        assert (frt.launch_train_fwd.launches, frt.launch_train_bwd.launches) == (before[0] + 1, before[1] + 1)
        assert frt.launch_train_bwd.split_launches == split_before + split
        errs.append((f"S={s} white_back={int(white_back)} noise={int(use_noise)}",
                     chip_smoke.k3_fwd_error(out, ref, 6.0), chip_smoke.k3_fwd_error(earlier, ref, 6.0),
                     chip_smoke.grad_errors(got, want)))
    return errs


def _single_ray_means(device):
    """The new forward's mean error per output (rgb, depth / far, weights,
    rgb_s, alphas) over SINGLE_RAYS launches of one ray each per case."""
    rng = np.random.default_rng(1001)
    packed = pack_weights(chip_smoke.make_model(2, device), torch.bfloat16)
    sums, counts = [0.0] * 5, [0] * 5
    for s, white_back, use_noise in CASES:
        for _ in range(SINGLE_RAYS):
            rays, z, noise = _case_inputs(rng, device, 1, s, use_noise)
            out = frt.launch_train_fwd(packed, rays, z, noise, True, white_back)
            ref = frt.render_level_train_forward_plain(packed, rays, z, noise, True, white_back)
            for k, (g, r, scale) in enumerate(zip(out, ref, (1.0, 6.0, 1.0, 1.0, 1.0))):
                d = (g - r).abs() / scale
                assert bool(d.isfinite().all())
                sums[k] += d.double().sum().item()
                counts[k] += d.numel()
    return [sm / c for sm, c in zip(sums, counts)]


@pytest.mark.cuda
def test_flush_ablation_drops_only_the_weight_flush(cuda_device):
    """The flush-only ablation leaves the biases and the blocks summed outside the wgrad
    flush (wrgb, wsig, wdx) as they were and the flushed blocks at zero."""
    rng = np.random.default_rng(3)
    model = chip_smoke.make_model(2, cuda_device)
    rays, z = chip_smoke.make_rays(rng, 333, 12, cuda_device)
    packed = pack_weights(model, torch.bfloat16)
    out = frt.launch_train_fwd(packed, rays, z, None, True, False)
    g = chip_smoke.cotangents(out, torch.zeros(333, 3, device=cuda_device))
    args = (packed, rays, z, None, out[2], out[3], out[4], *g, True, False)
    full = frt.launch_train_bwd(*args)
    ablated = frt.launch_train_bwd_ablated("flush", *args)
    torch.cuda.synchronize()
    def close(x, y):  # the atomics add in another order from run to run
        return (x - y).abs().max() <= 1e-5 * y.abs().max()

    assert close(ablated[1], full[1])
    for name, (off, (rows, cols)) in WEIGHT_OFFSETS.items():
        part, ref = ablated[0][off : off + rows * cols], full[0][off : off + rows * cols]
        if name in ("wrgb", "wsig", "wdx"):
            assert close(part, ref), name
        else:
            assert not part.any() and ref.any(), name
    assert ablated[0].shape == (WEIGHT_SIZE,) and len(unpack_grads(*ablated)) == 24
