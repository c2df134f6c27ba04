"""X2, the pipelining experiments on K3-bwd, against the JAX experiment.

On the CPU ``run_variant`` runs its plain versions: the production plain
backward (``render_level_train_backward_plain``) for the exact variants
(``base``, ``two_stream``, ``pe_pipe``) and ``ablation_plain`` for the
timing ablations.  Every variant is held against the JAX script's own
Pallas kernel (``scripts/exp_bwd_pipeline.py::_exp_bwd_kernel``) in
interpret mode, through ``jax_variant_grads``, which sets the kernel up as
the script's ``run_variant`` does (:327-376) and returns all 26 gradient
buffers (the script returns the first only).  128 rays x S = 8; both sides
read the same numpy-seeded weights, rays, depths and cotangents and the
residuals of JAX's production forward.  The exact variants are also held
against JAX's production backward ``_frlt_bwd``.

Tolerances, per parameter leaf as (largest difference over the leaf's
largest entry, relative L2), split as the K3 parity tests split them.  The
leaves whose gradient passes no ReLU mask of the trunk (rgb, direction,
xyz_encoding_final, sigma): (1e-2, 1e-2), measured 1.7e-3 / 9.7e-4 (bf16
deltas rounded after float32 sums taken in other orders; JAX sums its bias
gradients in bf16).  The trunk leaves of the variants whose trunk masks read
activations of the sample's PE (base, no_db, no_dw, two_stream, pe_pipe):
the ReLU-flip band (2e-1, 1e-1), measured 1.2e-1 / 3.8e-2: the two packages'
PE differs in its last bits (jnp against torch sin/cos), a bf16 cast of x
or of an activation then rounds to the neighbouring value, and a mask flips
where a pre-activation lies within that of zero, changing one unit's delta
at one point by its whole size; 1024 points average little of it (one
float32 ulp of the inputs moves the port's own bf16 trunk gradients by
4e-2 to 7e-2, ``tests/test_torch_fused_mlp.py::
test_k4_gradient_band_is_one_input_ulp``).  The trunk leaves of no_mask,
mxu_floor and cheap_pe, which have no mask or no PE, are held like the
mask-free leaves, (1e-2, 1e-2), measured 2.5e-3 / 1.4e-3: there is no band
to hide a fault of the trunk's arithmetic.

Tests marked ``cuda`` launch the kernels and skip without a card."""

import functools
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sinnerf_tpu.ops.fused_mlp_t import _unpack_grads_t, pack_weights_t, round8
from sinnerf_tpu.ops.fused_render_train_t import RAY_OUT, _frlt_bwd, _prep, _run_fwd, _weight_specs
from sinnerf_tpu_torch.models.nerf import nerf_from_state, random_params, state_dict_from_jax
from sinnerf_tpu_torch.ops.fused_mlp import pack_weights, param_tensors, unpack_grads
from sinnerf_tpu_torch.scripts import exp_bwd_pipeline as x2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

N, S = 128, 8
MASK_FREE = ("rgb", "dir_encoding", "xyz_encoding_final", "sigma")
TOL_TIGHT, TOL_TRUNK = (1e-2, 1e-2), (2e-1, 1e-1)
PE_FREE = ("no_mask", "mxu_floor", "cheap_pe")  # no trunk mask, or no PE under it
# (variant, JAX r_tile, JAX n_streams)
CASES = [("base", 128, 1), ("no_db", 128, 1), ("no_mask", 128, 1), ("no_dw", 128, 1), ("mxu_floor", 128, 1),
         ("cheap_pe", 128, 1), ("two_stream", 128, 2), ("pe_pipe", 128, 1)]


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_exp_bwd_pipeline",
                                                  os.path.join(REPO, "scripts", "exp_bwd_pipeline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def params():
    p = random_params(np.random.default_rng(61))
    p["sigma"]["b"] = p["sigma"]["b"] + np.float32(0.3)  # a partly opaque field
    return p


@pytest.fixture(scope="module")
def jax_inputs(params):
    """JAX ``main``'s inputs (:402-417) at 128 x 8: rays (6, N), z (N, S),
    the JAX params, the production forward's residuals and the cotangents."""
    rng = np.random.default_rng(7)
    o = rng.normal(size=(3, N)).astype(np.float32) * 0.1
    d = rng.normal(size=(3, N)).astype(np.float32)
    rays_t = jnp.asarray(np.concatenate([o, d], axis=0))
    z = jnp.asarray(np.sort(rng.uniform(2.0, 6.0, size=(N, S)).astype(np.float32), axis=1))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    _, w_t, a_t, rgb_t = _run_fwd(p, rays_t, z, None, True, False, "bfloat16")
    g = (jnp.asarray(rng.normal(size=(N, 3)).astype(np.float32)),
         jnp.asarray(rng.normal(size=(N,)).astype(np.float32)),
         jnp.asarray(rng.normal(size=(N, S)).astype(np.float32) * 0.01))
    return rays_t, z, p, w_t, a_t, rgb_t, g


def jax_variant_grads(script, variant, r_tile, n_streams, inputs):
    """The script's ``run_variant`` set-up (:327-376), returning the 26
    gradient buffers unpacked to the JAX params' layout."""
    rays_t, z_vals, params, w_t, a_t, rgb_t, g = inputs
    n, s = z_vals.shape
    s8 = round8(s)
    rays8, z_t, _, _, n_pad = _prep(rays_t, z_vals, None, r_tile)
    nt = n + n_pad
    g_rgb, g_depth, g_w = g

    def pad_lanes(x):
        return jnp.pad(x, ((0, 0), (0, nt - x.shape[1])))

    gout = pad_lanes(jnp.concatenate([g_rgb.T, g_depth[None], jnp.zeros((RAY_OUT - 4, n), jnp.float32)], axis=0))
    gw_t = pad_lanes(jnp.pad(g_w.T, ((0, s8 - s), (0, 0))))
    w_p, a_p, rgb_p = (pad_lanes(x[:, :n]) if x.shape[1] != nt else x for x in (w_t, a_t, rgb_t))
    operands = pack_weights_t(params, jnp.bfloat16)

    def tiled(rows):
        return pl.BlockSpec((rows, r_tile), lambda i: (0, i), memory_space=pltpu.VMEM)

    in_specs = [tiled(RAY_OUT), tiled(s8), tiled(s8), tiled(s8), tiled(3 * s8), tiled(RAY_OUT), tiled(s8)]
    in_specs += _weight_specs(operands)
    shapes = [op.shape for op in operands]
    kernel = functools.partial(
        script._exp_bwd_kernel, n_samples=s, cdtype="bfloat16",
        abl=frozenset() if variant in ("base", "two_stream") else frozenset([variant]), n_streams=n_streams)
    outs = pl.pallas_call(
        kernel, grid=(nt // r_tile,), in_specs=in_specs,
        out_specs=[pl.BlockSpec(sh, lambda i: (0, 0), memory_space=pltpu.VMEM) for sh in shapes],
        out_shape=[jax.ShapeDtypeStruct(sh, jnp.float32) for sh in shapes],
        scratch_shapes=[pltpu.VMEM((s8, r_tile), jnp.float32)], interpret=True,
    )(rays8, z_t, w_p, a_p, rgb_p, gout, gw_t, *operands)
    assert len(outs) == 26
    return _unpack_grads_t(outs[:14], outs[14:], params)


def port_inputs(jax_in, device="cpu"):
    """The same inputs in the port's layouts."""
    rays_t, z, params, w_t, a_t, rgb_t, g = jax_in
    n, s = z.shape
    s8 = round8(s)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=device).contiguous()

    rgb = np.asarray(rgb_t)[:, :n].reshape(3, s8, n)[:, :s].transpose(2, 1, 0)
    model = nerf_from_state(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))).to(device)
    return x2.BwdInputs(pack_weights(model, torch.bfloat16), t(np.asarray(rays_t).T), t(z),
                        t(np.asarray(w_t)[:s, :n].T), t(np.asarray(a_t)[:s, :n].T), t(rgb), t(g[0]), t(g[1]), t(g[2]))


def leaves(params, dw, db):
    """Packed gradients -> {state-dict name: numpy} of the reference layout."""
    model = nerf_from_state(state_dict_from_jax(params))
    names = {id(p): k for k, p in model.named_parameters()}
    return {names[id(p)]: g.cpu().numpy() for p, g in zip(param_tensors(model), unpack_grads(dw, db))}


def hold_leaves(got, want, what):
    """Each leaf within its band (module docstring); a leaf that is zero in
    the reference (an ablation's dropped sums) must be zero."""
    worst = {}
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if not np.abs(w).any():
            assert not np.abs(g).any(), (what, name)
            continue
        diff = g.astype(np.float64) - w
        err = (np.abs(diff).max() / np.abs(w).max(), np.linalg.norm(diff) / np.linalg.norm(w))
        tol = TOL_TIGHT if name.split(".")[0] in MASK_FREE or what in PE_FREE else TOL_TRUNK
        assert err[0] <= tol[0] and err[1] <= tol[1], (what, name, err)
        worst[name.split(".")[0]] = max(worst.get(name.split(".")[0], (0.0, 0.0)), err)
    return worst


@pytest.fixture(scope="module")
def jax_grads(params, jax_inputs):
    script = _jax_script()
    out = {case: jax_variant_grads(script, *case, jax_inputs) for case in CASES}
    rays_t, z, p, w_t, a_t, rgb_t, g = jax_inputs
    out["production"] = _frlt_bwd(True, False, "bfloat16", (p, rays_t, z, None, w_t, a_t, rgb_t), g)[0]
    return {k: state_dict_from_jax(jax.tree_util.tree_map(np.asarray, v)) for k, v in out.items()}


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-x{c[2]}")
def test_variant_matches_jax(params, jax_inputs, jax_grads, case):
    variant, _, n_streams = case
    rays = 32 if variant == "two_stream" else 64
    got = leaves(params, *x2.run_variant(variant, rays, n_streams, port_inputs(jax_inputs)))
    want = {k: v.numpy().astype(np.float64) for k, v in jax_grads[case].items()}
    assert any(np.abs(v).max() > 0 for k, v in want.items() if k.startswith("xyz_encoding_1.")), "empty field"
    hold_leaves(got, want, variant)
    if variant in x2.EXACT:  # and JAX's production backward
        hold_leaves(got, {k: v.numpy().astype(np.float64) for k, v in jax_grads["production"].items()}, variant)


def test_jax_ablations_drop_what_they_name(jax_grads):
    """The JAX kernels' ablated gradients are zero where the ablation drops
    a sum (so the port's zeros are held to something), and nowhere else."""
    for case in CASES:
        variant = case[0]
        for name, g in jax_grads[case].items():
            dropped = (variant in ("no_db", "mxu_floor") and name.endswith("bias")) or \
                      (variant == "no_dw" and name.endswith("weight") and not name.startswith("dir_encoding"))
            assert bool(np.abs(g.numpy()).max() == 0) == dropped, (variant, name)


def test_two_stream_is_the_production_gradient(params, jax_inputs):
    """The exact variants' plain versions are one function: two_stream's
    dsig_part folds the transmittance in, which the plain version computes
    alike."""
    i = port_inputs(jax_inputs)
    base = x2.run_variant("base", 64, 1, i)
    for variant, rays, streams in (("two_stream", 32, 2), ("two_stream", 64, 2), ("pe_pipe", 64, 1)):
        got = x2.run_variant(variant, rays, streams, i)
        assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])


def test_launcher_raises_on_what_the_kernel_does_not_take(params, jax_inputs):
    i = port_inputs(jax_inputs)
    odd = i._replace(z=i.z[:, :7].contiguous(), weights=i.weights[:, :7].contiguous(),
                     alphas=i.alphas[:, :7].contiguous(), rgb_s=i.rgb_s[:, :7].contiguous(),
                     g_w=i.g_w[:, :7].contiguous())
    with pytest.raises(ValueError, match="streams"):
        x2.run_variant("two_stream", 32, 2, odd)  # JAX's half = S // 2 drops a sample
    x2.run_variant("base", 64, 1, odd)  # one stream takes any S
    with pytest.raises(ValueError, match="noise"):
        x2.run_variant("base", 64, 1, i._replace(noise=torch.zeros_like(i.z)))
    with pytest.raises(ValueError, match="black background"):
        x2.run_variant("base", 64, 1, i._replace(white_back=True))
    model = nerf_from_state(state_dict_from_jax(params))
    with pytest.raises(ValueError, match="bfloat16"):
        x2.run_variant("base", 64, 1, i._replace(packed=pack_weights(model, torch.float32)))
    with pytest.raises(ValueError):
        x2.run_variant("base", 32, 1, i)  # not built
    with pytest.raises(ValueError):
        x2.run_variant("no_db", 64, 2, i)
    with pytest.raises(ValueError):
        x2.run_variant("warp_speed", 64, 1, i)
    with pytest.raises(ValueError):
        x2.run_variant("base", 64, 1, i._replace(z=i.z.double()))


def test_cpu_launcher_does_not_count_launches(jax_inputs):
    before = dict(x2.launch_variant.launches)
    x2.run_variant("no_mask", 64, 1, port_inputs(jax_inputs))
    assert dict(x2.launch_variant.launches) == before


def test_spec_and_bounds():
    assert [e[0] for e in x2.parse_spec(x2.DEFAULT_SPEC)] == ["base", "no_db", "no_mask", "no_dw", "mxu_floor",
                                                               "two_stream", "two_stream"]
    assert {e[0] for e in x2.parse_spec(x2.ALL_SPEC)} == set(x2.VARIANTS)
    for variant, rays, streams in x2.parse_spec(x2.ALL_SPEC):
        assert (x2.VARIANT_IDS[variant], rays, streams) in x2.BUILT
    assert x2.bound_ms("base", 16384, 192) == pytest.approx(11.064, abs=1e-3)  # chip_smoke's K3-bwd bound
    assert x2.bound_ms("no_dw", 16384, 192) == pytest.approx(11.064 * 1_149_952 / 1_739_264, abs=1e-3)


@pytest.mark.parametrize("n,s,seed", chip_smoke.X2_SMALL)
def test_smoke_shapes_are_no_empty_field(n, s, seed):
    """The card's small-shape holds read a field where the sigma gate is
    open (at some samples for the first shape, at all for the ragged one):
    on an empty field every gradient is 0 and a kernel would agree with
    anything."""
    i = x2.make_inputs(n, s, seed, torch.device("cpu"))
    open_share = (i.alphas > 0).float().mean().item()
    assert open_share > 0.1, open_share
    if (n, s, seed) == chip_smoke.X2_SMALL[0]:
        assert open_share < 0.9, open_share
    dw, db = x2.variant_plain("base", i)
    assert dw.abs().max() > 0 and db.abs().max() > 0


def test_ratios_are_per_round():
    from sinnerf_tpu_torch.scripts import ratios

    got = ratios({"base": [2.0, 4.0], "v": [1.0, 6.0]}, "base")
    assert got == {"base": [1.0, 1.0], "v": [0.5, 1.5]}


def test_module_imports_neither_jax_nor_the_jax_package():
    code = ("import sys\nimport sinnerf_tpu_torch.scripts.exp_bwd_pipeline\n"
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
@pytest.mark.parametrize("n,s", [(128, 8), (333, 10)])
@pytest.mark.parametrize("entry", x2.ALL_SPEC.split(","))
def test_variant_kernel_matches_plain(cuda_device, entry, n, s):
    variant, rays, streams = x2.parse_spec(entry)[0]
    i = x2.make_inputs(n, s, 5, cuda_device)
    tag = f"{variant}:{rays}:{streams}"
    before = x2.launch_variant.launches[tag]
    got = x2.run_variant(variant, rays, streams, i)
    torch.cuda.synchronize()
    assert x2.launch_variant.launches[tag] == before + 1
    chip_smoke.hold_grads(f"X2 {tag} vs plain", chip_smoke.grad_errors(unpack_grads(*got),
                                                                     unpack_grads(*x2.variant_plain(variant, i))),
                          chip_smoke.K3_BWD_TOL["bfloat16"])
    if variant in x2.EXACT:  # against base, the earlier K3-bwd whose body the variants share
        err = x2.leaf_errors(got, x2.run_variant("base", 64, 1, i))
        assert err[0] <= x2.EXACT_TOL_SMALL[0] and err[1] <= x2.EXACT_TOL_SMALL[1], err
