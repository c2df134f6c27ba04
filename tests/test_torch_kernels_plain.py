"""The port's kernel modules against the JAX kernels, and the kernels against
their plain versions on the card.

On the CPU the wrappers (``fused_render_level``, ``fused_sample_pdf_merge``)
run their plain versions; these are held against the JAX Pallas kernels run
in interpret mode, as the JAX package's own tests run them.  Each JAX
reference is computed once per module.  Tolerances: K1 float32 rtol/atol
2e-5 (different summation orders in 13 products); K1 bfloat16 2e-2 on rgb and
weights (an activation can round to a neighbouring bf16 value), 2e-2 relative
on depth; K2 rtol 1e-5, atol 1e-6 (JAX takes the CDF as a matmul, the port
sums in order; near the 1e-5 pdf guard an ulp moves a sample).

Tests marked ``cuda`` build and launch the CUDA kernels and skip without a
card."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sinnerf_tpu.ops.fused_render_t import fused_render_level as jax_render_level
from sinnerf_tpu.ops.fused_sample_pdf_t import fused_sample_pdf_merge as jax_pdf_merge
from sinnerf_tpu_torch.core.activations import shifted_softplus, widened_sigmoid
from sinnerf_tpu_torch.core.composite import composite
from sinnerf_tpu_torch.core.encoding import positional_encoding_recurrence
from sinnerf_tpu_torch.models.nerf import nerf_from_state, random_params, state_dict_from_jax
from sinnerf_tpu_torch.ops import fused_mlp
from sinnerf_tpu_torch.ops.fused_render import fused_render_level, render_level_plain
from sinnerf_tpu_torch.ops.fused_sample_pdf import fused_sample_pdf_merge, sample_pdf_merge_plain

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

N_RAYS, S = 111, 12  # not a tile multiple; S not a multiple of 8
RENDER_CASES = [("float32", False), ("float32", True), ("bfloat16", False)]
PDF_CASES = [(77, 8, 8), (64, 10, 12), (33, 64, 64), (40, 16, 1)]


@pytest.fixture(scope="module")
def params():
    p = random_params(np.random.default_rng(21))
    p["sigma"]["b"] = p["sigma"]["b"] + np.float32(0.3)  # a partly opaque field
    return p


@pytest.fixture(scope="module")
def render_inputs():
    rng = np.random.default_rng(21)
    o = rng.normal(scale=0.3, size=(N_RAYS, 3))
    d = rng.normal(scale=0.3, size=(N_RAYS, 3)) + [0.0, 0.0, -1.0]
    rays = np.concatenate([o, d], 1).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, size=(N_RAYS, S)), axis=1).astype(np.float32)
    return rays, z


@pytest.fixture(scope="module")
def jax_renders(params, render_inputs):
    rays, z = render_inputs
    return {
        case: [np.asarray(a) for a in jax_render_level(params, jnp.asarray(rays.T), jnp.asarray(z), True, case[1], case[0])]
        for case in RENDER_CASES
    }


@pytest.mark.parametrize("compute_dtype,white_back", RENDER_CASES)
def test_render_level_plain_matches_jax(params, render_inputs, jax_renders, compute_dtype, white_back):
    rays, z = render_inputs
    model = nerf_from_state(state_dict_from_jax(params))
    got = [g.detach() for g in fused_render_level(model, torch.from_numpy(rays), torch.from_numpy(z), True, white_back,
                                                   compute_dtype)]  # differentiable: its backward recomputes through K4
    want = jax_renders[(compute_dtype, white_back)]
    assert float(want[2].sum(1).max()) > 0.1, "the field must not be empty"
    if compute_dtype == "float32":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=2e-5)
    else:
        rgb, depth, weights = (g.numpy() for g in got)
        np.testing.assert_allclose(rgb, want[0], rtol=0, atol=2e-2)
        np.testing.assert_allclose(weights, want[2], rtol=0, atol=2e-2)
        np.testing.assert_allclose(depth, want[1], rtol=2e-2, atol=2e-2)


def _pdf_inputs(n, s, k):
    rng = np.random.default_rng(31 + n + s + k)
    z = np.sort(rng.uniform(2, 6, size=(n, s)), axis=1).astype(np.float32)
    w = rng.uniform(0, 1, size=(n, s)).astype(np.float32)
    u = rng.uniform(0, 1, size=(n, k)).astype(np.float32)
    return z, w, u


@pytest.fixture(scope="module")
def jax_pdf_merges():
    out = {}
    for n, s, k in PDF_CASES:
        z, w, u = _pdf_inputs(n, s, k)
        for det in (True, False):
            out[(n, s, k, det)] = np.asarray(
                jax_pdf_merge(jnp.asarray(z), jnp.asarray(w), k, None if det else jnp.asarray(u), det)
            )
    return out


@pytest.mark.parametrize("det", [True, False])
@pytest.mark.parametrize("n,s,k", PDF_CASES)
def test_sample_pdf_merge_plain_matches_jax(jax_pdf_merges, n, s, k, det):
    z, w, u = _pdf_inputs(n, s, k)
    got = fused_sample_pdf_merge(torch.from_numpy(z), torch.from_numpy(w), k, None if det else torch.from_numpy(u), det)
    assert got.shape == (n, s + k)
    np.testing.assert_allclose(got.numpy(), jax_pdf_merges[(n, s, k, det)], rtol=1e-5, atol=1e-6)


def test_wrappers_check_their_inputs(params, render_inputs):
    rays, z = render_inputs
    model = nerf_from_state(state_dict_from_jax(params))
    with pytest.raises(TypeError):
        fused_render_level(model, torch.from_numpy(rays).double(), torch.from_numpy(z))
    with pytest.raises(ValueError):
        fused_render_level(model, torch.from_numpy(rays)[:, :5], torch.from_numpy(z))
    with pytest.raises(ValueError):
        fused_sample_pdf_merge(torch.from_numpy(z), torch.from_numpy(z), 8, None, det=False)
    with pytest.raises(ValueError):
        fused_sample_pdf_merge(torch.from_numpy(z)[:, :2], torch.from_numpy(z)[:, :2], 8)


def test_cpu_wrappers_do_not_count_launches(params, render_inputs):
    rays, z = render_inputs
    model = nerf_from_state(state_dict_from_jax(params))
    k1, k2 = fused_render_level.launches, fused_sample_pdf_merge.launches
    _, _, w = fused_render_level(model, torch.from_numpy(rays), torch.from_numpy(z))
    fused_sample_pdf_merge(torch.from_numpy(z), w, 8)
    assert (fused_render_level.launches, fused_sample_pdf_merge.launches) == (k1, k2)


# --------------------------------------------------------------------------
# chip_smoke.py's bfloat16 limits: rounding passes, planted faults fail
# --------------------------------------------------------------------------


def _render_bf16(model, rays, z, fault):
    """``render_level_plain`` in bfloat16 restated, with one fault planted:
    a legitimate other summation order, products rounded to bf16, or a cast
    point left out."""
    v = fused_mlp.weight_views(fused_mlp.pack_weights(model, torch.bfloat16))
    n, s = z.shape
    o, d = rays[:, 0:3], rays[:, 3:6]
    x_pe = positional_encoding_recurrence(o[:, None] + d[:, None] * z[..., None], 10).reshape(n * s, -1)
    d_pe = positional_encoding_recurrence(d, 4)[:, None].expand(n, s, -1).reshape(n * s, -1)

    def dot(a, name):
        w = v[name]
        if fault == "bf16 products":
            return (a.bfloat16() @ w.T).float()
        if fault == "other sum order":
            k = a.shape[-1] // 2
            return a[:, k:].float() @ w[:, k:].float().T + a[:, :k].float() @ w[:, :k].float().T
        return a.float() @ w.float().T

    def relu_cast(y, layer):
        y = torch.relu(y)
        return y if fault == "layer 7 not cast" and layer == 7 else y.bfloat16()

    x = fused_mlp.pe_concat(x_pe, fused_mlp.XYZ_PAD, torch.bfloat16)
    h = x
    for i in range(1, 9):
        a = dot(h, f"w{i}") if i != 5 else dot(h, "w5h") + dot(x, "w5x")
        h = relu_cast(a + v[f"b{i}"], i)
    sigma = (dot(h, "wsig") + v["bsig"])[:, 0]
    f = dot(h, "wfin") + v["bfin"]
    f = f if fault == "final not cast" else f.bfloat16()
    a_d = dot(f, "wdh") + dot(fused_mlp.pe_concat(d_pe, fused_mlp.DIR_PAD, torch.bfloat16), "wdx") + v["bd"]
    rgb = widened_sigmoid(dot(shifted_softplus(a_d).bfloat16(), "wrgb") + v["brgb"])
    comp = composite(rgb.view(n, s, 3), sigma.view(n, s), z, d)
    return comp.rgb, comp.depth, comp.weights


@pytest.fixture(scope="module")
def smoke_field():
    """chip_smoke.py's first K1 check field, at fewer rays."""
    rays, z = chip_smoke.make_rays(np.random.default_rng(0), 256, 32, "cpu")
    model = chip_smoke.make_model(1, "cpu")
    return model, rays, z, render_level_plain(model, rays, z, True, False, "bfloat16")


@pytest.mark.parametrize("fault", ["none", "other sum order", "bf16 products", "final not cast", "layer 7 not cast"])
def test_bf16_limits_pass_rounding_and_fail_planted_faults(smoke_field, fault):
    model, rays, z, want = smoke_field
    got = _render_bf16(model, rays, z, fault)
    max_err, mean_err = chip_smoke.k1_error(got, want)
    max_tol, mean_tol = chip_smoke.K1_TOL["bfloat16"]
    if fault in ("none", "other sum order"):
        assert max_err <= max_tol and mean_err <= mean_tol, (max_err, mean_err)
    else:
        assert max_err > max_tol or mean_err > mean_tol, (max_err, mean_err)


# --------------------------------------------------------------------------
# on the card: each kernel against its plain version
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_render_kernel_matches_plain(cuda_device, params, render_inputs, compute_dtype):
    rays, z = render_inputs
    model = nerf_from_state(state_dict_from_jax(params)).to(cuda_device)
    r, zz = torch.from_numpy(rays).to(cuda_device), torch.from_numpy(z).to(cuda_device)
    before = fused_render_level.launches
    got = fused_render_level(model, r, zz, True, True, compute_dtype)
    torch.cuda.synchronize()
    assert fused_render_level.launches == before + 1
    want = render_level_plain(model, r, zz, True, True, compute_dtype)
    max_err, mean_err = chip_smoke.k1_error(got, want)
    max_tol, mean_tol = chip_smoke.K1_TOL[compute_dtype]
    assert max_err <= max_tol and mean_err <= mean_tol, (max_err, mean_err)


@pytest.mark.cuda
@pytest.mark.parametrize("det", [True, False])
@pytest.mark.parametrize("n,s,k", PDF_CASES)
def test_sample_pdf_kernel_matches_plain(cuda_device, n, s, k, det):
    z, w, u = (torch.from_numpy(a).to(cuda_device) for a in _pdf_inputs(n, s, k))
    got = fused_sample_pdf_merge(z, w, k, None if det else u, det)
    torch.cuda.synchronize()
    want = sample_pdf_merge_plain(z, w, k, None if det else u, det)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
