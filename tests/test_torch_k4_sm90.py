"""K4 on Hopper in the three places it was redesigned last: the bfloat16
backward and forward (``csrc/fused_mlp_sm90.cu``: K3-bwd bf16's wgmma body at
one sample per ray, and its recompute without keeping, ``k4_fwd_sm90``) and
the float32 forward (``k4_fwd_f32_sm90`` of ``csrc/f32_train_sm90.cu``,
K4-bwd f32's recompute without keeping).

On the CPU: the bf16 backward's slab order (the producer's, with the wdx,
w5x and w1 slabs it streams for the input gradients read as the MN-major B
of one-slab dgrads), the bf16 forward's sigma-only slabs, the kernels' shared
memory, the bf16 backward's scratch and the lane map of its input gradients,
the launch plans at ragged counts and at the deterministic step's, and that
CPU tensors take the plain versions and count no launch.

Tests marked ``cuda`` build and launch the kernels and skip without a card:
both dtypes against their plain versions at 333 and 70,001 points with and
without ``sigma_only`` under ``chip_smoke.py``'s K4 limits, the sigma-only
forward equal to the full one's sigma, the earlier kernels kept for the
timing rounds against theirs, and the refusal of other cards.  The file
imports no JAX."""

import math
import os
import re
import sys

import numpy as np
import pytest
import torch

from sinnerf_tpu_torch.models.nerf import nerf_from_state, random_params, state_dict_from_jax
from sinnerf_tpu_torch.ops import fused_mlp as fm
from sinnerf_tpu_torch.ops import sm90_layout as L
from sinnerf_tpu_torch.ops.fused_mlp import WEIGHT_OFFSETS, pack_weights

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

H100_SMS = 132
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on an H100
RAGGED_POINTS = (1, 127, 129, 333, 70_001)
PATH_POINTS = (1_048_576, 3_145_728)  # K4 on the deterministic step: 16,384 rays x 64 and x 192
FWD_BF16_POINTS = (1, 127, 128, 333, 20_001, 3_145_728)
CARD_POINTS = (333, 70_001)


@pytest.fixture(scope="module")
def model():
    return nerf_from_state(state_dict_from_jax(random_params(np.random.default_rng(11))))


def _k4_bwd_slab(j: int) -> int:
    """A mirror of csrc/fused_mlp_sm90.cu's k4_bwd_slab: wdx's slab (38),
    then K3's bwd_slab(j - 1) up to w6, w5x's (17), K3's bwd_slab(j - 2) from
    w5h to w2, w1's (0)."""
    first = [34, 30, 26, 22, 18, 13, 9, 5, 1]

    def bwd(i):
        return first[i // 4] + i % 4

    return 38 if j == 0 else bwd(j - 1) if j <= 20 else 17 if j == 21 else bwd(j - 2) if j <= 37 else 0


def test_k4_bwd_slab_order_matches_the_kernel():
    """After the recompute's 39 slabs the producer streams K3's 36 backward
    slabs and the three of K4's input gradients where its consumers take
    them: wdx before the direction layer's, w5x before w5h's, w1 last."""
    blocks = [L.FWD_SLABS[i].block for i in L.K4_BWD_SLABS]
    assert blocks == (["wdx"] + ["wdh"] * 4 + ["wfin"] * 4 + ["w8"] * 4 + ["w7"] * 4 + ["w6"] * 4 + ["w5x"]
                      + ["w5h"] * 4 + ["w4"] * 4 + ["w3"] * 4 + ["w2"] * 4 + ["w1"])
    assert list(L.K4_BWD_SLABS) == [_k4_bwd_slab(j) for j in range(39)]
    k3 = [i for i in L.K4_BWD_SLABS if L.FWD_SLABS[i].block not in ("wdx", "w5x", "w1")]
    assert k3 == list(L.BWD_SLABS)


@pytest.mark.parametrize("block", ["wdx", "w5x", "w1"])
def test_input_gradient_slabs_read_as_mn_major_b(model, block):
    """The slab of an input gradient's dgrad is the forward's own bytes: row o
    of the slab (128 bytes along the block's 64 input columns, swizzled) is
    row o of the reduction over outputs, so unswizzled it is the block W[o][c]
    with zeros past its columns; it starts on a 1,024-byte boundary."""
    packed = pack_weights(model, torch.bfloat16)
    slabs = L.slab_buffer(packed)
    (index,) = [i for i in L.K4_BWD_SLABS if L.FWD_SLABS[i].block == block]
    s, start = L.FWD_SLABS[index], L.SLAB_OFFSETS[index]
    off, (rows, cols) = WEIGHT_OFFSETS[block]
    assert start % 1024 == 0 and s.k0 == 0 and s.rows == rows
    tile = L.unswizzle(slabs[start // 2 : start // 2 + rows * L.SW], rows)
    want = torch.zeros(rows, L.SW, dtype=torch.bfloat16)
    want[:, :cols] = packed.w[off : off + rows * cols].view(rows, cols)
    assert torch.equal(tile.view(torch.int16), want.view(torch.int16))


def test_k4_fwd_bf16_sigma_only_slabs():
    """The bf16 forward's producer streams slabs 0 .. count - 1 of FWD_SLABS
    (the count the kernel reports is held against these when it loads): all
    39, or for the sigma-only pass the 30 of w1 .. w8, in the order layers
    1..8 read them (w5h before w5x: one accumulator)."""
    assert L.K4_SIGMA_SLABS == tuple(range(30))
    blocks = [L.FWD_SLABS[i].block for i in L.K4_SIGMA_SLABS]
    assert blocks == (["w1"] + ["w2"] * 4 + ["w3"] * 4 + ["w4"] * 4 + ["w5h"] * 4 + ["w5x"]
                      + ["w6"] * 4 + ["w7"] * 4 + ["w8"] * 4)
    assert {s.block for s in L.FWD_SLABS[30:]} == {"wfin", "wdh", "wdx"}
    assert all(s.rows == 256 for s in L.FWD_SLABS[:30])


@pytest.mark.parametrize("kernel,smem", [("k4_bwd_bf16", L.BWD_SMEM), ("k4_fwd_f32", L.K4_F32_FWD_SMEM),
                                         ("k4_fwd_bf16", L.k4_fwd_launch_plan(1, H100_SMS, False)["smem"])])
def test_shared_memory_arithmetic(kernel, smem):
    """The bf16 backward takes K3-bwd bf16's shared memory and no tile more
    (the input gradients go to scratch); the f32 forward K4-bwd f32's; the
    bf16 forward K3-fwd bf16's (an activation tile, the xyz and direction PE,
    three ring stages: one CTA per SM)."""
    want = {"k4_bwd_bf16": 2 * 65_536 + 16_384 + 2 * 32_768 + 8_192 + 1_024,
            "k4_fwd_f32": 131_072 + 32_768 + 3 * 16_384 + 7_232 + 2_560,
            "k4_fwd_bf16": 65_536 + 2 * 16_384 + 3 * 32_768 + 8_192 + 1_024}[kernel]
    assert smem == want <= SMEM_LIMIT


def test_k4_bwd_scratch_layout():
    """Per CTA: the nine kept tiles (64 KB each, their shared-memory images),
    da_d per point [128][128] f32, then dxpe [128][64] and ddpe [128][32]
    f32, each on a 16-byte boundary."""
    kept = 9 * L.ACT_BYTES
    assert L.ACT_BYTES == 65_536 and L.BWD_SCRATCH == kept + 128 * 128 * 4
    dxp, ddp = L.BWD_SCRATCH, L.BWD_SCRATCH + 128 * 64 * 4
    assert L.K4_BWD_SCRATCH == ddp + 128 * 32 * 4 == 704_512
    assert dxp % 16 == 0 and ddp % 16 == 0


def _input_grad_cells(t: int, cols: int):
    """(point, column) pairs of consumer thread t's input-gradient sums
    (mlp_backward_wgmma.cuh::input_grad): the m64n64 accumulator of its
    warpgroup g, rows 64 g + 16 w + l // 4 + 8 i, columns 8 j + 2 (l % 4) + e,
    j < cols / 8."""
    g, tt = divmod(t, 128)
    w, lane = divmod(tt, 32)
    rows = [64 * g + 16 * w + lane // 4 + 8 * i for i in range(2)]
    return [(r, 8 * j + 2 * (lane % 4) + e) for r in rows for j in range(cols // 8) for e in range(2)]


@pytest.mark.parametrize("cols", [64, 32])
def test_input_gradient_lanes_cover_the_scratch_once(cols):
    """dxpe (64 columns) and ddpe (32): the 256 consumers' float2 stores cover
    [128][cols] once, each 8-byte aligned, each thread the same cells in
    every call (so layer 1 adds to layer 5's sums)."""
    hits = np.zeros((128, cols), dtype=int)
    for t in range(256):
        cells = _input_grad_cells(t, cols)
        for p, c in cells:
            hits[p, c] += 1
        assert all(c % 2 == 0 for p, c in cells[::2])
    assert (hits == 1).all()


@pytest.mark.parametrize("n", RAGGED_POINTS + PATH_POINTS)
def test_k4_launch_plans(n):
    """Tiles of 128 points, one persistent CTA per SM at most, each walking
    tiles ctas apart: every point once; the slabs a CTA streams and the
    launch's scratch."""
    tiles = math.ceil(n / 128)
    bwd = L.k4_bwd_launch_plan(n, H100_SMS)
    fwd = {so: L.k4_fwd_f32_launch_plan(n, H100_SMS, so) for so in (False, True)}
    per_cta = np.bincount(np.arange(tiles) % min(tiles, H100_SMS))
    for plan in (bwd, *fwd.values()):
        assert plan["tiles"] == tiles and plan["ctas"] == min(tiles, H100_SMS) and plan["threads"] == 384
        assert plan["tiles_per_cta"] == per_cta.max() and per_cta.sum() == tiles and plan["smem"] <= SMEM_LIMIT
    assert bwd["slabs_per_cta"] == per_cta.max() * (39 + 39)
    assert bwd["scratch_bytes"] == bwd["ctas"] * 704_512
    # the sigma-only pass streams the slabs of w1 .. w8: 4 + 7 x 16 + 4 of 16 rows
    assert fwd[False]["slabs_per_cta"] == per_cta.max() * 154 and fwd[True]["slabs_per_cta"] == per_cta.max() * 120


@pytest.mark.parametrize("n", FWD_BF16_POINTS)
def test_k4_fwd_bf16_launch_plan(n):
    """The bf16 forward's tiles of 128 points on persistent CTAs: every point
    once, K3-fwd bf16's CTA (205,824 bytes, one per SM), 39 slabs per tile
    or 30 for the sigma-only pass."""
    tiles = math.ceil(n / 128)
    per_cta = np.bincount(np.arange(tiles) % min(tiles, H100_SMS))
    for sigma_only, slabs in ((False, 39), (True, 30)):
        plan = L.k4_fwd_launch_plan(n, H100_SMS, sigma_only)
        assert plan["tiles"] == tiles and plan["ctas"] == min(tiles, H100_SMS) and plan["threads"] == 384
        assert plan["tiles_per_cta"] == per_cta.max() and per_cta.sum() == tiles
        assert plan["smem"] == 205_824 and 2 * plan["smem"] > SMEM_LIMIT
        assert plan["slabs_per_cta"] == per_cta.max() * slabs


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("sigma_only", [False, True])
def test_cpu_tensors_run_the_plain_versions_and_count_no_launch(model, compute_dtype, sigma_only):
    rng = np.random.default_rng(5)
    counters = (fm.launch_mlp_fwd, fm.launch_mlp_bwd, fm.launch_mlp_fwd_block64, fm.launch_mlp_bwd_wmma,
                fm.launch_mlp_bwd_block64, fm.launch_mlp_fwd_wmma)
    before = [c.launches for c in counters]
    xyz = torch.tensor(rng.normal(size=(40, 3)), dtype=torch.float32, requires_grad=True)
    dirs = None if sigma_only else torch.tensor(rng.normal(size=(40, 3)), dtype=torch.float32, requires_grad=True)
    out = fm.fused_nerf_mlp(model, xyz, dirs, sigma_only=sigma_only, compute_dtype=compute_dtype)
    packed = pack_weights(model, fm.torch_dtype(compute_dtype))
    assert torch.equal(out.detach(), fm.nerf_mlp_forward_plain(packed, xyz.detach(), dirs, True, sigma_only))
    out.square().sum().backward()
    assert xyz.grad is not None and bool(xyz.grad.isfinite().all())
    assert sigma_only or bool(dirs.grad.isfinite().all())
    model.zero_grad()
    assert [c.launches for c in counters] == before


def test_earlier_launchers_refuse_the_other_dtype(model):
    """The earlier kernels stay for the timing rounds, each in the dtype it
    was replaced in; the flush ablation times the bf16 Hopper backward."""
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        fm.launch_mlp_fwd_block64(pack_weights(model, torch.bfloat16), x, x)
    f32 = pack_weights(model, torch.float32)
    for launch in (fm.launch_mlp_bwd_wmma, fm.launch_mlp_bwd_ablated):
        with pytest.raises(ValueError):
            launch(f32, x, x, torch.zeros(4, 4))


def test_earlier_bf16_forward_refuses_float32(model):
    """The earlier wmma forward stays for the timing rounds in bfloat16, the
    dtype it was replaced in."""
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        fm.launch_mlp_fwd_wmma(pack_weights(model, torch.float32), x, x)


@pytest.mark.parametrize("module", ["ops/fused_mlp.py", "ops/sm90_layout.py"])
def test_the_k4_modules_import_no_jax(module):
    src = open(os.path.join(os.path.dirname(os.path.dirname(L.__file__)), module)).read()
    assert not re.search(r"^\s*(import|from)\s+(jax|sinnerf_tpu)\b", src, re.M)


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
@pytest.mark.parametrize("n", CARD_POINTS)
@pytest.mark.parametrize("sigma_only", [False, True])
def test_k4_sm90_kernels_match_plain(cuda_device, n, sigma_only):
    """K4-fwd and K4-bwd in both dtypes, all on Hopper kernels (the bf16
    forward newest), against their plain versions: every dW/db leaf,
    dxyz and ddir under chip_smoke.py's K4 limits (``k4_bwd_tol``: the short
    tail's at 333 points); one forward and two backward launches each."""
    rng = np.random.default_rng(500 + n)
    model = chip_smoke.make_model(4, cuda_device)
    xyz = torch.tensor(rng.normal(scale=2.0, size=(n, 3)), dtype=torch.float32, device=cuda_device)
    dirs = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device=cuda_device)
    g = torch.tensor(rng.normal(size=(n, 1 if sigma_only else 4)), dtype=torch.float32, device=cuda_device)
    for cd in ("bfloat16", "float32"):
        before = fm.launch_mlp_fwd.launches, fm.launch_mlp_bwd.launches
        err_f, err_b, spread, _ = chip_smoke.k4_check(model, xyz, dirs, g, cd, sigma_only, f"K4 {cd} n={n}")
        assert (fm.launch_mlp_fwd.launches, fm.launch_mlp_bwd.launches) == (before[0] + 1, before[1] + 2)
        print(f"{cd} n={n} sigma_only={int(sigma_only)}: fwd {err_f}, bwd {err_b}, two runs {spread}")


@pytest.mark.cuda
def test_k4_sigma_only_forward_is_the_full_passs_sigma(cuda_device):
    """The sigma-only pass runs the full pass's trunk, in both dtypes: the
    same sigma, bit for bit."""
    rng = np.random.default_rng(6)
    model = chip_smoke.make_model(4, cuda_device)
    xyz = torch.tensor(rng.normal(scale=2.0, size=(5_000, 3)), dtype=torch.float32, device=cuda_device)
    dirs = torch.tensor(rng.normal(size=(5_000, 3)), dtype=torch.float32, device=cuda_device)
    for dtype in (torch.float32, torch.bfloat16):
        packed = pack_weights(model, dtype)
        full = fm.launch_mlp_fwd(packed, xyz, dirs)
        sigma = fm.launch_mlp_fwd(packed, xyz, None, True, True)
        assert torch.equal(sigma[:, 0].view(torch.int32), full[:, 3].view(torch.int32)), dtype


@pytest.mark.cuda
def test_earlier_k4_launchers_match_plain(cuda_device):
    """The earlier kernels kept for the timing rounds (the forward in both
    dtypes, the bf16 backward) and the bf16 backward without its flush,
    which leaves dxyz and ddir whole and the trunk's dW at zero."""
    rng = np.random.default_rng(7)
    model = chip_smoke.make_model(4, cuda_device)
    n = 20_001
    xyz = torch.tensor(rng.normal(scale=2.0, size=(n, 3)), dtype=torch.float32, device=cuda_device)
    dirs = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device=cuda_device)
    g = torch.tensor(rng.normal(size=(n, 4)), dtype=torch.float32, device=cuda_device)
    f32, bf16 = pack_weights(model, torch.float32), pack_weights(model, torch.bfloat16)
    diff = (fm.launch_mlp_fwd_block64(f32, xyz, dirs) - fm.nerf_mlp_forward_plain(f32, xyz, dirs)).abs()
    chip_smoke.hold("earlier K4-fwd f32", (diff.max().item(), diff.mean().item()), chip_smoke.K4_FWD_TOL["float32"])
    before = fm.launch_mlp_fwd_wmma.launches
    diff = (fm.launch_mlp_fwd_wmma(bf16, xyz, dirs) - fm.nerf_mlp_forward_plain(bf16, xyz, dirs)).abs()
    assert fm.launch_mlp_fwd_wmma.launches == before + 1
    chip_smoke.hold("earlier K4-fwd bf16", (diff.max().item(), diff.mean().item()), chip_smoke.K4_FWD_TOL["bfloat16"])
    want = fm.nerf_mlp_backward_plain(bf16, xyz, dirs, g)
    chip_smoke.hold_grads("earlier K4-bwd bf16", chip_smoke.k4_bwd_error(fm.launch_mlp_bwd_wmma(bf16, xyz, dirs, g), want)[0],
                          chip_smoke.K4_BWD_TOL)
    dw, db, dxyz, ddir = fm.launch_mlp_bwd_ablated(bf16, xyz, dirs, g)
    views = fm.weight_views(fm.PackedWeights(dw, db))
    assert not any(bool(views[b].any()) for b in ("w1", "w2", "w5h", "w5x", "wfin", "wdh"))
    for got, ref in ((dxyz, want[2]), (ddir, want[3])):
        assert chip_smoke.input_grad_error(got, ref)[1] <= chip_smoke.K4_BWD_TOL[1]


@pytest.mark.cuda
def test_k4_sm90_kernels_refuse_other_cards(cuda_device, monkeypatch):
    rng = np.random.default_rng(8)
    model = chip_smoke.make_model(4, cuda_device)
    xyz = torch.tensor(rng.normal(size=(10, 3)), dtype=torch.float32, device=cuda_device)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda *a, **k: (8, 0))
    for dtype in (torch.float32, torch.bfloat16):
        for sigma_only in (False, True):
            with pytest.raises(RuntimeError):
                fm.launch_mlp_fwd(pack_weights(model, dtype), xyz, xyz, True, sigma_only)
    with pytest.raises(RuntimeError):
        fm.launch_mlp_bwd(pack_weights(model, torch.bfloat16), xyz, xyz, torch.zeros(10, 4, device=cuda_device))
