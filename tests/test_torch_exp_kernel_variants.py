"""X1, the forward-kernel variants of K4-fwd, against the JAX experiment.

On the CPU ``make_variant``'s forward runs its plain version
(``variant_plain``: K4-fwd's plain version for the in-kernel-PE variants,
``mlp_plain`` on the pre-encoded rows for the others).  Every row of the
grid is held against the JAX script's own Pallas kernel
(``scripts/exp_kernel_variants.py::make_variant(in_pe, ilp, 128)``) in
interpret mode, on the same numpy points and directions and the same
weights, at 256 points (two JAX tiles of 128 lanes).  JAX's pre-encoded
variants read the blocked PE layout with weights packed for it, the port's
the interleaved one with its own packing.  ``base`` is
``make_variant(False, 1, 128)``: the script's own ``base`` row calls
``_forward_t`` with an argument list that function no longer takes, so the
JAX production reference here is ``fused_nerf_mlp_t``.

Tolerance: bfloat16 outputs 2e-4 absolute, as K4's parity test
(``tests/test_torch_fused_mlp.py``): the two packages sum the layers'
products in other orders (and the two PE layouts order the first layer's
sum differently), so an activation can round to a neighbouring bf16 value
(measured 5.7e-5 on every row).

The Hopper kernels' host-side layouts are pinned here too: the pre-encoded
variants' swizzled PE tiles byte for byte against ``sm90_layout.act_offset``,
the 2-CTA cluster's tile walk, and the CTA's shared memory.

Tests marked ``cuda`` launch the kernels and skip without a card."""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sinnerf_tpu.core.encoding import positional_encoding_blocked_t
from sinnerf_tpu.ops.fused_mlp_t import DIR_CH, DIR_PAD, XYZ_CH, XYZ_PAD, fused_nerf_mlp_t, pack_weights_t
from sinnerf_tpu_torch.models.nerf import nerf_from_state, random_params, state_dict_from_jax
from sinnerf_tpu_torch.ops import fused_mlp as fm
from sinnerf_tpu_torch.ops import sm90_layout
from sinnerf_tpu_torch.scripts import exp_kernel_variants as x1

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

N = 256
TOL = 2e-4


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_exp_kernel_variants",
                                                  os.path.join(REPO, "scripts", "exp_kernel_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def params():
    p = random_params(np.random.default_rng(91))
    p["sigma"]["b"] = p["sigma"]["b"] + np.float32(0.3)  # a partly opaque field
    return p


def _points(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3)).astype(np.float32), rng.normal(size=(n, 3)).astype(np.float32)


def _packed(params, device="cpu"):
    return fm.pack_weights(nerf_from_state(state_dict_from_jax(params)).to(device), torch.bfloat16)


def _port(params, name, xyz, dirs, device="cpu"):
    in_pe, ilp, tile = x1.GRID[name]
    xyz, dirs = torch.from_numpy(xyz).to(device), torch.from_numpy(dirs).to(device)
    a, b = (xyz, dirs) if in_pe else x1.encode(xyz, dirs)
    return x1.make_variant(in_pe, ilp, tile)(_packed(params, device), a, b)


@pytest.fixture(scope="module")
def jax_outputs(params):
    """Each grid row's JAX kernel at tile 128, plus JAX's production K4-fwd
    (``fused_nerf_mlp_t``), as (N, 4) ``[rgb, sigma]``."""
    script = _jax_script()
    operands = jax.tree_util.tree_map(jnp.asarray, pack_weights_t(jax.tree_util.tree_map(jnp.asarray, params),
                                                                   jnp.bfloat16))
    xyz, dirs = (jnp.asarray(a.T) for a in _points(N))
    x_packed = jnp.concatenate([xyz, dirs, jnp.zeros((2, N), jnp.float32)], axis=0)
    xpe = jnp.pad(positional_encoding_blocked_t(xyz, 10, out_dtype=jnp.bfloat16), ((0, XYZ_PAD - XYZ_CH), (0, 0)))
    dpe = jnp.pad(positional_encoding_blocked_t(dirs, 4, out_dtype=jnp.bfloat16), ((0, DIR_PAD - DIR_CH), (0, 0)))
    out = {}
    for name, (in_pe, ilp, _) in x1.GRID.items():
        rgb, sig = script.make_variant(in_pe, ilp, 128)(x_packed if in_pe else xpe, None if in_pe else dpe, operands)
        out[name] = np.concatenate([np.asarray(rgb)[0:3].T, np.asarray(sig)[0:1].T], axis=1)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    out["production"] = np.asarray(fused_nerf_mlp_t(p, xyz, dirs, False, True, "bfloat16")).T
    return out


@pytest.mark.parametrize("name", list(x1.GRID))
def test_variant_matches_jax(params, jax_outputs, name):
    got = _port(params, name, *_points(N)).numpy()
    want = jax_outputs[name]
    assert got.shape == want.shape == (N, 4)
    assert np.isfinite(got).all() and float(np.abs(want[:, 3]).max()) > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=name)


def test_jax_variants_agree_with_jax_production(jax_outputs):
    """The JAX grid computes what JAX's production K4-fwd computes, the
    in-kernel PE included: the reference the port is held to is one
    function."""
    for name in x1.GRID:
        np.testing.assert_allclose(jax_outputs[name], jax_outputs["production"], rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("name", list(x1.GRID))
def test_ragged_tail(params, name):
    """At 333 points (JAX's grid would drop the tail) every point gets its
    output: the first 256 are the 256-point call's (up to the CPU GEMM's
    blocking, 1e-6), and the in-kernel-PE and pre-encoded variants agree on
    all of them."""
    xyz, dirs = _points(333)
    got = _port(params, name, xyz, dirs).numpy()
    assert got.shape == (333, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got[:N], _port(params, name, xyz[:N], dirs[:N]).numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, _port(params, "pe", xyz, dirs).numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("ka,kb", [(64, 128), (5, 3), (1, 1)])
def test_bitonic_merge_equals_sort(ka, kb):
    """Equal to ``torch.sort`` of the concatenation, ties and infinities
    included: rows drawn from a few values, with -inf and +inf entries."""
    rng = np.random.default_rng(ka * 1000 + kb)
    vals = np.array([-np.inf, 2.0, 3.0, 3.0, 4.5, np.inf], np.float32)
    a = torch.sort(torch.from_numpy(rng.choice(vals, size=(40, ka))), dim=-1)[0]
    b = torch.sort(torch.from_numpy(rng.choice(vals, size=(40, kb))), dim=-1)[0]
    want = torch.sort(torch.cat([a, b], dim=-1), dim=-1)[0]
    got = x1.bitonic_merge_sorted(a, b)
    assert got.shape == want.shape
    assert torch.equal(got, want)
    z = torch.sort(torch.rand(64, ka), dim=-1)[0], torch.sort(torch.rand(64, kb), dim=-1)[0]
    assert torch.equal(x1.bitonic_merge_sorted(*z), torch.sort(torch.cat(z, dim=-1), dim=-1)[0])


def test_launcher_checks_its_inputs(params):
    xyz, dirs = (torch.from_numpy(a) for a in _points(16))
    packed = _packed(params)
    with pytest.raises(ValueError):
        x1.make_variant(True, 2, 512)  # not in the grid
    with pytest.raises(ValueError):
        x1.make_variant(False, 4, 128)
    fwd = x1.make_variant(True, 1, 128)
    with pytest.raises(ValueError, match="bfloat16"):
        fwd(fm.pack_weights(nerf_from_state(state_dict_from_jax(params)), torch.float32), xyz, dirs)
    with pytest.raises(ValueError):
        fwd(packed, xyz.double(), dirs)
    with pytest.raises(ValueError):
        fwd(packed, xyz[:, :2].contiguous(), dirs)
    with pytest.raises(ValueError):
        fwd(packed, torch.from_numpy(np.asfortranarray(xyz.numpy())), dirs)
    with pytest.raises(ValueError):
        x1.make_variant(False, 1, 128)(packed, xyz, dirs)  # wants the pre-encoded rows


@pytest.mark.parametrize("n", [1, 127, 128, 333])
def test_pe_tiles_are_the_kernels_swizzled_tiles(n):
    """The pre-encoded variants' bulk-copied PE: per 128-point tile the XPE
    image then the DPE image, each row's columns where the kernels' swizzle
    puts them (``sm90_layout.act_offset``, the device's ``sw_off``), zeros
    past the points and past dpe's 32 columns; bit for bit, and back."""
    xyz, dirs = (torch.from_numpy(a) for a in _points(n, seed=n))
    xpe, dpe = x1.encode(xyz, dirs)
    tiles = x1.pe_tiles(xpe, dpe)
    assert tiles.dtype == torch.bfloat16 and tiles.numel() * 2 == -(-n // 128) * x1.PE_TILE_BYTES
    want = np.zeros(tiles.numel(), np.int16)
    p, c = np.arange(n)[:, None], np.arange(64)[None, :]
    at = (p // 128) * x1.PE_TILE_BYTES + sm90_layout.act_offset(p % 128, c)
    want[at // 2] = xpe.view(torch.int16).numpy()
    want[(at[:, :32] + sm90_layout.PE_BYTES) // 2] = dpe.view(torch.int16).numpy()
    np.testing.assert_array_equal(tiles.view(torch.int16).numpy(), want)
    images = [sm90_layout.unswizzle(t, 128) for t in tiles.view(-1, 128 * 64)]  # and back
    assert torch.equal(torch.cat(images[0::2])[:n].view(torch.int16), xpe.view(torch.int16))
    assert torch.equal(torch.cat(images[1::2])[:n, :32].view(torch.int16), dpe.view(torch.int16))


@pytest.mark.parametrize("n,clusters", [(5 * 128, 2), (7 * 128 - 5, 3), (1, 66), (3 * 128, 66), (x1.N_POINTS + 1, 66)])
def test_cluster_plan_pairs_the_ctas(n, clusters):
    """pe_ilp2_t2x's tile walk: every tile once, the two CTAs of a cluster on
    neighbouring tiles of one pair for the same number of turns (they meet
    on each slab's barriers), an odd count's last pair with one tile past
    the points (run, not stored)."""
    plan = x1.cluster_plan(n, clusters)
    tiles, walk = plan["tiles"], plan["walk"]
    assert plan["ctas"] == 2 * plan["clusters"] <= 2 * clusters and len(walk) == plan["ctas"]
    assert sorted(t for ts in walk.values() for t in ts if t < tiles) == list(range(tiles))
    assert [t for ts in walk.values() for t in ts if t >= tiles] == ([tiles] if tiles % 2 else [])
    for c in range(plan["clusters"]):
        assert [t + 1 for t in walk[c, 0]] == walk[c, 1]


def test_kernels_fit_in_shared_memory():
    """Every variant runs K4-fwd bf16's CTA: its shared memory (the ring,
    the activation and PE tiles, the rays and eight barriers) within the
    227 KB a block may take."""
    assert x1.SMEM == sm90_layout.FWD_SMEM <= 232_448
    assert x1.PE_TILE_BYTES == 2 * sm90_layout.PE_BYTES  # the XPE and DPE tiles are adjacent in FwdSmem


def test_cpu_launcher_does_not_count_launches(params):
    before = dict(x1.launch_variant.launches)
    _port(params, "pe_ilp2", *_points(16))
    assert dict(x1.launch_variant.launches) == before


def test_module_imports_neither_jax_nor_the_jax_package():
    code = ("import sys\nimport sinnerf_tpu_torch.scripts.exp_kernel_variants\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'sinnerf_tpu'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


# --------------------------------------------------------------------------
# on the card: each variant's kernel against its plain version
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 333])
@pytest.mark.parametrize("name", list(x1.GRID))
def test_variant_kernel_matches_plain(cuda_device, params, name, n):
    """Each variant's Hopper kernel against its plain version and against
    ``pe``; ``pe`` is production K4-fwd bf16, bit for bit."""
    in_pe, ilp, tile = x1.GRID[name]
    xyz, dirs = (torch.from_numpy(a).to(cuda_device) for a in _points(n, seed=n))
    a, b = (xyz, dirs) if in_pe else x1.encode(xyz, dirs)
    packed = _packed(params, cuda_device)
    before = x1.launch_variant.launches[name]
    got = x1.make_variant(in_pe, ilp, tile)(packed, a, b)
    torch.cuda.synchronize()
    assert x1.launch_variant.launches[name] == before + 1
    prod = fm.launch_mlp_fwd(packed, xyz, dirs)
    pe = x1.make_variant(True, 1, 128)(packed, xyz, dirs)
    assert torch.equal(pe, prod)
    for ref in (x1.variant_plain(packed, in_pe, a, b), pe):
        diff = (got - ref).abs()
        chip_smoke.hold(f"X1 {name} n={n}", (diff.max().item(), diff.mean().item()), chip_smoke.K4_FWD_TOL["bfloat16"])
