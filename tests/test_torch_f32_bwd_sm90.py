"""The float32 training kernels on Hopper (``csrc/f32_train_sm90.cu``):
their layouts and launch plans on the CPU, and on the card the kernels
themselves against their plain versions.

K3-fwd f32 is K1 f32's kernel with noise and residuals; K3-bwd f32 and
K4-bwd f32 run ``csrc/mlp_backward_f32_sm90.cuh``, which streams three kinds
of slab through one ring: the recompute's (``sm90_layout.F32_SLABS``), the
layer inputs of the weight gradients read back from the CTA's global
scratch, and the dgrad weights, 16 output rows of a packed block each.  A
value in the wrong place gives sums that are finite and plausible, so the
CPU tests pin the dgrad slabs (a round trip to ``pack_weights``' layout bit
for bit, in the order the kernels consume them), the scratch layout, the
shared-memory budget, the register tiles of wgrad and dgrad (a Python mirror
of the kernel's maps, covering each layer once without shared-memory bank
conflicts) and the launch plan at ragged counts.

Tests marked ``cuda`` build and launch the kernels and skip without a card:
K3 f32 and K4-bwd f32 against their plain versions at ragged shapes under
``chip_smoke.py``'s limits, K3-fwd f32 without noise bit-equal to K1 f32,
the earlier float32 kernels against their plain versions, and the refusal of
other cards.  The file imports no JAX."""

import math
import os
import sys

import numpy as np
import pytest
import torch

from sinnerf_tpu_torch.models.nerf import nerf_from_state, random_params, state_dict_from_jax
from sinnerf_tpu_torch.ops import fused_mlp as fm
from sinnerf_tpu_torch.ops import fused_render as fr
from sinnerf_tpu_torch.ops import fused_render_train as frt
from sinnerf_tpu_torch.ops import sm90_layout as L
from sinnerf_tpu_torch.ops.fused_mlp import WEIGHT_OFFSETS, pack_weights, unpack_grads

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

H100_SMS = 132
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on an H100
RAY_COUNTS = (1, 127, 129, 1000, 5292)
POINT_COUNTS = (333, 70_001)
PATH_POINTS = (1_048_576, 3_145_728)  # K4 on the deterministic step: 16,384 rays x 64 and x 192


@pytest.fixture(scope="module")
def model():
    return nerf_from_state(state_dict_from_jax(random_params(np.random.default_rng(9))))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def _dgrad_blocks(k4: bool):
    out = ["wdh", "wfin", "w8", "w7", "w6"] + (["w5x"] if k4 else []) + ["w5h", "w4", "w3", "w2"]
    return out + (["w1"] if k4 else [])


@pytest.mark.parametrize("k4", [False, True])
def test_dgrad_slabs_round_trip_the_packed_weights_bit_for_bit(model, k4):
    """The dgrad slabs, in the order the kernel consumes them, are 16 output
    rows each of pack_weights' own float32 bytes: per block they stack back
    to the block, and each starts on a 16-byte boundary for its bulk copy."""
    packed = pack_weights(model, torch.float32)
    slabs = [s for s in L.f32_bwd_slabs(k4) if s.source == "weights"]
    blocks = []
    for s in slabs:
        if not blocks or blocks[-1] != s.name:
            blocks.append(s.name)
    assert blocks == _dgrad_blocks(k4)
    for block in blocks:
        off, (rows, cols) = WEIGHT_OFFSETS[block]
        mine = [s for s in slabs if s.name == block]
        assert [s.index for s in mine] == list(range(rows // L.F32_ROWS))
        assert all(s.offset % 16 == 0 and s.nbytes == 4 * L.F32_ROWS * cols for s in mine)
        stacked = torch.cat([L.dgrad_slab(packed.w, s) for s in mine])
        assert torch.equal(_bits(stacked), _bits(packed.w[off : off + rows * cols].view(rows, cols)))
    with pytest.raises(ValueError):
        L.dgrad_slab(packed.w, L.f32_bwd_slabs(k4)[0])


@pytest.mark.parametrize("k4", [False, True])
def test_backward_slab_order_matches_the_kernel(k4):
    """csrc/mlp_backward_f32_sm90.cuh's bwd_table: per layer the A slabs of
    its wgrad, then (K4) the input gradient's, then its dgrad slabs."""
    want = ["f"] * 8 + ["wdh"] * 8 + ["h8"] * 8 + ["wfin"] * 16
    for layer in range(8, 0, -1):
        if layer > 1:
            want += [f"h{layer - 1}"] * 8
        if layer in (5, 1):
            want += ["x"] * 2 + ([("w5x" if layer == 5 else "w1")] * 16 if k4 else [])
        if layer > 1:
            want += [("w5h" if layer == 5 else f"w{layer}")] * 16
    seq = L.f32_bwd_slabs(k4)
    assert [s.name for s in seq] == want and len(seq) == (244 if k4 else 212)
    # the layer input f streams both halves per point chunk (the direction
    # layer's two warpgroups each take one half); the trunk's, half by half
    assert [s.index for s in seq[:8]] == [0, 4, 1, 5, 2, 6, 3, 7]
    assert [s.index for s in seq[16:24]] == list(range(8))
    assert all(s.nbytes <= L.F32_ROWS * 256 * 4 for s in seq)


def test_scratch_layout():
    """Kept tile t is [half][point][128] f32 at t x 128 KB; an A slab (half
    h, chunk c) holds points 32c..32c+31 of the half; the sample PE is
    [point][64] after the nine tiles; then the ReLU masks and the 64 KB of
    K3's per-ray sums (or K4's input gradients)."""
    assert L.F32_KEPT_BYTES == 131_072 and L.F32_XPE_OFFSET == 9 * 131_072
    assert L.F32_BWD_SCRATCH == 9 * 131_072 + 32_768 + 32_768 + 65_536 == 1_310_720
    kept = {}
    for s in L.f32_bwd_slabs(False):
        if s.source == "kept" and s.name != "x":
            h, c = divmod(s.index, 4)
            assert s.offset == L.F32_KEPT.index(s.name) * L.F32_KEPT_BYTES + h * L.F32_HALF_BYTES + c * 32 * 128 * 4
            kept.setdefault(s.name, set()).add(s.offset)
    assert sorted(kept) == sorted(L.F32_KEPT) and all(len(v) == 8 for v in kept.values())
    # the recompute's stores (KeepBwd): thread t's (point, output) at its place
    for t in range(256):
        for p in _points(t):
            for o in _outputs(t, 256):
                h, at = divmod((o // 128) * L.F32_HALF_BYTES + 4 * (p * 128 + o % 128), L.F32_HALF_BYTES)
                assert (h, at // (32 * 128 * 4)) == (o // 128, p // 32)  # (half, A slab) of the value


def test_f32_backward_shared_memory_arithmetic():
    """K1 f32's 220,224 bytes and g_sigma, da_rgb and K3's transmittance per
    ray, 2,560: within the 232,448 a CTA may take."""
    assert L.F32_BWD_SMEM == 220_224 + 2_560 == 222_784 <= SMEM_LIMIT


# A Python mirror of the kernels' thread maps.  dgrad and the recompute:
# mlp_f32_sm90.cuh's Map, consumer thread t (warp w, lane l) holds points
# 32 (w % 4) + 16 i + 4 (l // 8) + e and outputs (O // 2) (w // 4) + 32 j +
# 4 (l % 8) + e.  wgrad: outputs ob + 4 i + l // 8 (i < 8) and inputs
# k0 + 4 (l % 8) + 32 j + e.  The delta tile places (row o, point p) at
# o * 128 + (p ^ ((o & 7) << 2)).
def _d_at(o, p):
    return o * 128 + (p ^ ((o & 7) << 2))


def _points(t):
    w, lane = divmod(t, 32)
    return [32 * (w % 4) + 16 * i + 4 * (lane // 8) + e for i in range(2) for e in range(4)]


def _outputs(t, o):
    w, lane = divmod(t, 32)
    return [(o // 2) * (w // 4) + 32 * j + 4 * (lane % 8) + e for j in range(o // 64) for e in range(4)]


def _wgrad_tile(t, layer):
    """(outputs, inputs) of thread t's wgrad accumulators, over all passes:
    ``trunk`` (256 x 256, two passes of input halves), ``dir`` (128 x 256,
    warpgroup g takes half g) and ``pe`` (256 x 64)."""
    w, lane = divmod(t, 32)
    q, og = divmod(lane, 8)
    if layer == "dir":
        ob, halves, tk = 32 * (w % 4), [w // 4], 16
    else:
        ob, halves, tk = 32 * w, ([0, 1] if layer == "trunk" else [0]), (16 if layer == "trunk" else 8)
    outs = [ob + 4 * i + q for i in range(8)]
    ins = [128 * h + 4 * og + 32 * j + e for h in halves for j in range(tk // 4) for e in range(4)]
    return outs, ins


def _wavefronts(chunks):
    """Shared-memory wavefronts of one warp-wide 16-byte access: distinct
    16-byte chunks are served 8 per wavefront (32 banks), those in the same
    bank group (chunk % 8) in separate ones; equal chunks are one broadcast."""
    per_group = np.bincount([c % 8 for c in set(chunks)], minlength=8)
    return int(per_group.max())


@pytest.mark.parametrize("layer,shape", [("trunk", (256, 256)), ("dir", (128, 256)), ("pe", (256, 64))])
def test_wgrad_tiles_cover_a_layer_once(layer, shape):
    hits = np.zeros(shape, dtype=int)
    for t in range(256):
        outs, ins = _wgrad_tile(t, layer)
        hits[np.ix_(outs, ins)] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("width", [256, 64])
def test_dgrad_tiles_cover_a_layer_once(width):
    hits = np.zeros((128, width), dtype=int)
    for t in range(256):
        for p in _points(t):
            hits[p, _outputs(t, width)] += 1
    assert (hits == 1).all()


def test_lane_maps_are_free_of_bank_conflicts():
    """dgrad: per D row, each of a warp's two float4 loads of points takes one
    wavefront, as do the weight loads; the epilogue's float4 stores of 32
    distinct chunks the least, four.  wgrad: per 4 points, each float4 of D
    (4 rows of one output group) and each float4 of A (32 inputs of a slab
    row) takes one wavefront."""
    for w in range(8):
        lanes = range(32 * w, 32 * w + 32)
        for o in range(32):  # dgrad: D rows as the reduction
            for i in range(2):
                assert _wavefronts([_d_at(o, _points(t)[4 * i]) // 4 for t in lanes]) == 1
            for j in range(4):
                assert _wavefronts([(o * 256 + _outputs(t, 256)[4 * j]) // 4 for t in lanes]) == 1
        for j in range(4):
            for e in range(4):
                for i in range(2):  # dgrad epilogue: output 4j + e as D's row, point group i
                    chunks = [_d_at(_outputs(t, 256)[4 * j + e], _points(t)[4 * i]) // 4 for t in lanes]
                    assert len(set(chunks)) == 32 and _wavefronts(chunks) == 4
        for layer in ("trunk", "dir", "pe"):
            tiles = [_wgrad_tile(t, layer) for t in lanes]
            for p in range(0, 128, 4):
                for i in range(8):
                    assert _wavefronts([_d_at(outs[i], p) // 4 for outs, _ in tiles]) == 1
            ld = 64 if layer == "pe" else 128
            for row in range(4):
                for j in range(len(tiles[0][1]) // 4 // (2 if layer == "trunk" else 1)):
                    assert _wavefronts([(row * ld + ins[4 * j] % ld) // 4 for _, ins in tiles]) == 1
    # the swizzle keeps a thread's point groups whole float4s
    for o in range(16):
        for p0 in range(0, 128, 4):
            assert [_d_at(o, p0 + e) for e in range(4)] == list(range(_d_at(o, p0), _d_at(o, p0) + 4))
        assert sorted(_d_at(o, p) for p in range(128)) == list(range(o * 128, o * 128 + 128))


@pytest.mark.parametrize("n,s,k4", [(n, s, False) for n in RAY_COUNTS + (16_384,) for s in (9, 12, 64)]
                         + [(n, 1, True) for n in POINT_COUNTS + PATH_POINTS])
def test_f32_backward_launch_plan(n, s, k4):
    plan = L.f32_bwd_launch_plan(n, s, H100_SMS, k4)
    tiles = math.ceil(n / 128)
    assert plan["tiles"] == tiles and plan["ctas"] == min(tiles, H100_SMS) and plan["threads"] == 384
    assert plan["smem"] == L.F32_BWD_SMEM <= SMEM_LIMIT
    assert plan["scratch_bytes"] == plan["ctas"] * 1_310_720
    # the persistent walk (tile = blockIdx + k * ctas) covers every ray or point once
    per_cta = np.bincount(np.arange(tiles) % plan["ctas"])
    cover = np.zeros(tiles * 128, dtype=int)
    for tile in range(tiles):
        cover[tile * 128 : (tile + 1) * 128] += 1
    assert (cover[:n] == 1).all() and per_cta.max() == plan["tiles_per_cta"]
    assert plan["slabs_per_cta"] == per_cta.max() * s * (154 + (244 if k4 else 212))


def test_cpu_tensors_run_the_plain_versions_and_count_no_launch(model):
    rng = np.random.default_rng(4)
    counters = (frt.launch_train_fwd, frt.launch_train_bwd, frt.launch_train_fwd_block64, frt.launch_train_bwd_block64,
                fm.launch_mlp_fwd, fm.launch_mlp_bwd, fm.launch_mlp_bwd_block64)
    before = [c.launches for c in counters]
    rays, z = chip_smoke.make_rays(rng, 20, 5, torch.device("cpu"))
    noise = torch.tensor(rng.normal(size=(20, 5)), dtype=torch.float32)
    rgb, depth, w = frt.fused_render_level_train(model, rays, z, noise, True, True, "float32")
    (rgb.square().sum() + depth.sum() + w.sum()).backward()
    got = [p.grad.clone() for p in frt.param_tensors(model)]
    model.zero_grad()
    rgb2, depth2, w2 = frt.render_level_train_plain(model, rays, z, noise, True, True, "float32")
    assert torch.equal(rgb, rgb2) and torch.equal(depth, depth2) and torch.equal(w, w2)
    xyz = torch.tensor(rng.normal(size=(30, 3)), dtype=torch.float32, requires_grad=True)
    dirs = torch.tensor(rng.normal(size=(30, 3)), dtype=torch.float32, requires_grad=True)
    fm.fused_nerf_mlp(model, xyz, dirs, compute_dtype="float32").sum().backward()
    assert xyz.grad is not None and dirs.grad is not None and all(bool(g.isfinite().all()) for g in got)
    model.zero_grad()
    assert [c.launches for c in counters] == before


def test_compare_builds_pairs_a_kernel_moved_into_a_namespace():
    """K1 f32's kernel became nerf::f32s::render_f32_sm90<false>: the build
    comparison still pairs it with the parent's render_f32_sm90."""
    from sinnerf_tpu_torch.scripts.compare_builds import pairs

    mine = {"nerf::f32s::render_f32_sm90<(bool)0>": 1, "nerf::k3::train_fwd_sm90<(bool)0>": 2, "k4_bwd_f32_sm90": 3}
    theirs = {"render_f32_sm90": 1, "nerf::k3::train_fwd_sm90<(bool)0>": 2}
    assert pairs(mine, theirs) == [("nerf::k3::train_fwd_sm90<(bool)0>", "nerf::k3::train_fwd_sm90<(bool)0>"),
                                   ("k4_bwd_f32_sm90", None),
                                   ("nerf::f32s::render_f32_sm90<(bool)0>", "render_f32_sm90")]


def test_earlier_f32_kernels_refuse_bfloat16(model):
    packed = pack_weights(model, torch.bfloat16)
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        fm.launch_mlp_bwd_block64(packed, x, x, torch.zeros(4, 4))
    w = torch.zeros(4, 2)
    with pytest.raises(ValueError):
        frt.launch_train_bwd_block64(packed, torch.zeros(4, 6), w, None, w, w, torch.zeros(4, 2, 3), torch.zeros(4, 3),
                                     torch.zeros(4), w, True, False)


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
def test_k3_f32_matches_plain_at_ragged_shapes(cuda_device, n):
    """K3-fwd f32 and K3-bwd f32 against their plain versions at n rays x
    S = 9 (noise, black background) and 12 (white), on the kernel forward's
    own residuals (``chip_smoke.k3_check``), under chip_smoke.py's K3 limits;
    one launch of each kernel per case and run."""
    rng = np.random.default_rng(200 + n)
    model = chip_smoke.make_model(2, cuda_device)
    for s, white_back, use_noise in ((9, False, True), (12, True, False)):
        rays, z = chip_smoke.make_rays(rng, n, s, cuda_device)
        noise = torch.tensor(rng.normal(size=(n, s)), dtype=torch.float32, device=cuda_device) if use_noise else None
        target = torch.tensor(rng.uniform(size=(n, 3)), dtype=torch.float32, device=cuda_device)
        before = frt.launch_train_fwd.launches, frt.launch_train_bwd.launches
        _, _, err_f, err_b, spread, _ = chip_smoke.k3_check(model, rays, z, noise, target, "float32", white_back,
                                                            f"K3 float32 n={n} S={s}")
        assert (frt.launch_train_fwd.launches, frt.launch_train_bwd.launches) == (before[0] + 1, before[1] + 2)
        print(f"n={n} S={s}: fwd {err_f}, bwd {err_b}, two runs {spread}")


@pytest.mark.cuda
@pytest.mark.parametrize("n", POINT_COUNTS)
@pytest.mark.parametrize("sigma_only", [False, True])
def test_k4_bwd_f32_matches_plain(cuda_device, n, sigma_only):
    """K4-bwd f32 against its plain version at point counts that are no tile
    multiple, every dW/db leaf, dxyz and ddir, under chip_smoke.py's K4
    limits (``k4_bwd_tol``: the short tail's at 333 points)."""
    rng = np.random.default_rng(300 + n)
    model = chip_smoke.make_model(4, cuda_device)
    xyz = torch.tensor(rng.normal(scale=2.0, size=(n, 3)), dtype=torch.float32, device=cuda_device)
    dirs = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device=cuda_device)
    g = torch.tensor(rng.normal(size=(n, 1 if sigma_only else 4)), dtype=torch.float32, device=cuda_device)
    before = fm.launch_mlp_bwd.launches
    err_f, err_b, spread, _ = chip_smoke.k4_check(model, xyz, dirs, g, "float32", sigma_only, f"K4 float32 n={n}")
    assert fm.launch_mlp_bwd.launches == before + 2
    print(f"n={n} sigma_only={int(sigma_only)}: bwd {err_b}, two runs {spread}")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 129, 1000])
def test_k3_fwd_f32_equals_k1_f32_without_noise(cuda_device, n):
    """One kernel template: K1 f32 and K3-fwd f32 with no noise give the same
    rgb, depth and weights, bit for bit."""
    rng = np.random.default_rng(400 + n)
    packed = pack_weights(chip_smoke.make_model(2, cuda_device), torch.float32)
    for s, white_back in ((9, False), (64, True), (13, False)):
        rays, z = chip_smoke.make_rays(rng, n, s, cuda_device)
        k1 = fr.launch_render(packed, rays, z, True, white_back)
        k3 = frt.launch_train_fwd(packed, rays, z, None, True, white_back)
        for a, b in zip(k1, k3[:3]):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (s, white_back)


@pytest.mark.cuda
def test_earlier_f32_kernels_match_plain(cuda_device):
    """The earlier float32 kernels, kept for the timing rounds, still hold."""
    rng = np.random.default_rng(7)
    model = chip_smoke.make_model(2, cuda_device)
    packed = pack_weights(model, torch.float32)
    rays, z = chip_smoke.make_rays(rng, 1000, 12, cuda_device)
    out = frt.launch_train_fwd_block64(packed, rays[:, :6].contiguous(), z, None, True, True)
    ref = frt.render_level_train_forward_plain(packed, rays[:, :6], z, None, True, True)
    err = chip_smoke.k3_fwd_error(out, ref, 6.0)
    assert err[0] <= chip_smoke.K3_FWD_TOL["float32"][0] and err[1] <= chip_smoke.K3_FWD_TOL["float32"][1], err
    target = torch.tensor(rng.uniform(size=(1000, 3)), dtype=torch.float32, device=cuda_device)
    args = (packed, rays[:, :6].contiguous(), z, None, out[2], out[3], out[4], *chip_smoke.cotangents(out, target),
            True, True)
    err_b = chip_smoke.grad_errors(unpack_grads(*frt.launch_train_bwd_block64(*args)),
                                   unpack_grads(*frt.render_level_train_backward_plain(*args)))
    tol = chip_smoke.K3_BWD_TOL["float32"]
    assert err_b[0] <= tol[0] and err_b[1] <= tol[1], err_b
    xyz = torch.tensor(rng.normal(scale=2.0, size=(20_001, 3)), dtype=torch.float32, device=cuda_device)
    dirs = torch.tensor(rng.normal(size=(20_001, 3)), dtype=torch.float32, device=cuda_device)
    g = torch.tensor(rng.normal(size=(20_001, 4)), dtype=torch.float32, device=cuda_device)
    got = fm.launch_mlp_bwd_block64(packed, xyz, dirs, g)
    want = fm.nerf_mlp_backward_plain(packed, xyz, dirs, g)
    err_k4 = chip_smoke.grad_errors(unpack_grads(*got[:2]), unpack_grads(*want[:2]))
    assert err_k4[0] <= chip_smoke.K4_BWD_TOL[0] and err_k4[1] <= chip_smoke.K4_BWD_TOL[1], err_k4


@pytest.mark.cuda
def test_f32_hopper_kernels_refuse_other_cards(cuda_device, monkeypatch):
    rng = np.random.default_rng(8)
    packed = pack_weights(chip_smoke.make_model(2, cuda_device), torch.float32)
    rays, z = chip_smoke.make_rays(rng, 10, 4, cuda_device)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda *a, **k: (8, 0))
    with pytest.raises(RuntimeError):
        frt.launch_train_fwd(packed, rays, z, None, True, False)
    with pytest.raises(RuntimeError):
        fm.launch_mlp_bwd(packed, rays[:, :3].contiguous(), rays[:, 3:6].contiguous(), torch.zeros(10, 4, device=cuda_device))
    w = torch.zeros_like(z)
    with pytest.raises(RuntimeError):
        frt.launch_train_bwd(packed, rays, z, None, w, w, torch.zeros(10, 4, 3, device=cuda_device),
                             torch.zeros(10, 3, device=cuda_device), torch.zeros(10, device=cuda_device), w, True, False)
