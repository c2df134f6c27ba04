"""The port's per-point MLP (K4) and K1's backward against the JAX package.

On the CPU ``fused_nerf_mlp`` runs its plain versions: ``nerf_mlp_plain``
forward and, in ``backward``, ``nerf_mlp_backward_plain`` (the recompute,
the MLP backward and ``pe_backward``).  They are held against the JAX
Pallas kernel ``fused_nerf_mlp_t`` in interpret mode and ``jax.vjp``
through it, on the same numpy-seeded weights, points, directions and
cotangents; point counts are no multiple of the JAX tiles (4096 forward,
1024 backward).  K1's gradient on the kernel path (``fused_render_level``,
whose backward recomputes through K4) is held against ``jax.grad`` of the
JAX ``render_rays(mlp_impl="pallas")`` with ``perturb=0, noise_std=0``.

Tolerances.  float32 outputs: rtol 1e-5, atol 1e-6 (measured 6e-8: the
same recurrence PE and cast points, other summation orders).  float32
gradients of the parameters: 1e-4 of each leaf's largest entry (measured
9e-7); of the points and directions 1e-4 of the largest entry (4e-7).
bfloat16 outputs: 2e-4 absolute (an activation can round to a neighbouring
bf16 value; measured 4.3e-5); bfloat16 parameter gradients 1e-2 of each
leaf's largest entry and relative L2 (measured 2.9e-3: the two packages
round the deltas' bf16 casts after sums in other orders, and JAX sums its
bias gradients in bf16), input gradients 1e-3 (1.1e-7 and 3.5e-7).  The
K1 gradient through the whole deterministic render (float32), per leaf as
(largest difference over the largest entry, relative L2): the leaves whose
gradient passes no ReLU mask of the trunk (final, sigma, direction, rgb)
(1e-4, 1e-4), measured 3.2e-6; the trunk leaves (5e-2, 1e-2), measured
1.9e-2 / 3.7e-3 on the coarse layers 1-3 and 1e-5 elsewhere: a mask flips
between the packages where a pre-activation lies within the PE
recurrence's ~1e-5 of zero, as ``tests/test_torch_train_step.py`` shows for
the stochastic step; the rays 1e-3 of the largest entry (measured 9.3e-5).

Tests marked ``cuda`` build and launch the CUDA kernels and skip without a
card."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sinnerf_tpu.ops.fused_mlp_t import _pe_bwd, _pe_fwd, fused_nerf_mlp_t
from sinnerf_tpu.render import renderer as jax_renderer
from sinnerf_tpu_torch.models.nerf import nerf_from_state, random_params, state_dict_from_jax
from sinnerf_tpu_torch.ops import fused_mlp as fm
from sinnerf_tpu_torch.ops import fused_render as fr
from sinnerf_tpu_torch.render import renderer as port_renderer

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

N = 300  # no multiple of the JAX forward (4096) or backward (1024) tile
CASES = [("float32", False), ("float32", True), ("bfloat16", False), ("bfloat16", True)]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite's workers share the machine's cores; more torch threads per
    worker only make them wait on each other (on 8 cores in 6 workers, a
    7 s test took 330 s at 8 threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _params(seed):
    p = random_params(np.random.default_rng(seed))
    p["sigma"]["b"] = p["sigma"]["b"] + np.float32(0.3)
    return p


@pytest.fixture(scope="module")
def params():
    return _params(81)


def _points(n, sigma_only, seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    g = rng.normal(size=(n, 1 if sigma_only else 4)).astype(np.float32)
    return xyz, dirs, g


@pytest.fixture(scope="module")
def jax_results(params):
    out = {}
    p = jax.tree_util.tree_map(jnp.asarray, params)
    for cd, sigma_only in CASES:
        xyz, dirs, g = _points(N, sigma_only)

        def run(pp, x, d, gg, cd=cd, sigma_only=sigma_only):
            y, vjp = jax.vjp(lambda a, b, c: fused_nerf_mlp_t(a, b, c, sigma_only, True, cd), pp, x, d)
            return y, vjp(gg)

        d_in = None if sigma_only else jnp.asarray(dirs.T)
        # XLA's CPU dot refuses bf16 x bf16 -> f32 once jitted: bf16 runs eagerly
        fn = jax.jit(run) if cd == "float32" else run
        y, (gp, gx, gd) = fn(p, jnp.asarray(xyz.T), d_in, jnp.asarray(g.T))
        out[cd, sigma_only] = (np.asarray(y).T, jax.tree_util.tree_map(np.asarray, gp), np.asarray(gx).T,
                               None if sigma_only else np.asarray(gd).T)
    return out


def _port(params, cd, sigma_only):
    xyz, dirs, g = (torch.from_numpy(a) for a in _points(N, sigma_only))
    xyz.requires_grad_()
    dirs = None if sigma_only else dirs.requires_grad_()
    model = nerf_from_state(state_dict_from_jax(params))
    out = fm.fused_nerf_mlp(model, xyz, dirs, sigma_only, True, cd)
    out.backward(g)
    grads = {k: p.grad.numpy() for k, p in model.state_dict(keep_vars=True).items()}
    return out.detach().numpy(), grads, xyz.grad.numpy(), None if sigma_only else dirs.grad.numpy()


@pytest.mark.parametrize("cd,sigma_only", CASES, ids=lambda c: str(c))
def test_point_mlp_matches_jax(params, jax_results, cd, sigma_only):
    """Forward, parameter gradients, dxyz and ddir of ``fused_nerf_mlp`` on
    the CPU against ``fused_nerf_mlp_t`` and its VJP."""
    got, grads, gx, gd = _port(params, cd, sigma_only)
    want, want_p, want_x, want_d = jax_results[cd, sigma_only]
    f32 = cd == "float32"
    assert got.shape == want.shape == (N, 1 if sigma_only else 4)
    np.testing.assert_allclose(got, want, rtol=1e-5 if f32 else 0, atol=1e-6 if f32 else 2e-4)
    want_p = state_dict_from_jax(want_p)
    assert set(grads) == set(want_p)
    for name, w in want_p.items():
        w = w.numpy()
        g = grads[name]
        if not np.abs(w).max() > 0:  # sigma only: the direction branch and rgb head get none
            assert sigma_only and not np.abs(g).max() > 0, name
            continue
        scale = np.abs(w).max()
        tol = 1e-4 if f32 else 1e-2
        np.testing.assert_allclose(g / scale, w / scale, rtol=0, atol=tol, err_msg=name)
        if not f32:
            assert np.linalg.norm(g - w) / np.linalg.norm(w) < 1e-2, name
    for g, w in ((gx, want_x), (gd, want_d)):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g / np.abs(w).max(), w / np.abs(w).max(), rtol=0, atol=1e-4 if f32 else 1e-3)


@pytest.mark.parametrize("n_freqs", [10, 4])
def test_pe_backward_matches_jax(n_freqs):
    """``pe_backward`` on the port's interleaved PE columns against JAX's
    ``_pe_bwd`` on its blocked rows: the same adjoint of the recurrence."""
    rng = np.random.default_rng(n_freqs)
    x = rng.normal(scale=3.0, size=(257, 3)).astype(np.float32)
    dpe = rng.normal(size=(257, 3 + 6 * n_freqs)).astype(np.float32)
    # interleaved [x, s0, c0, s1, c1, ...] -> blocked [x, s0..s(F-1), c0..c(F-1)]
    sins = [dpe[:, 3 + 6 * k : 6 + 6 * k] for k in range(n_freqs)]
    coss = [dpe[:, 6 + 6 * k : 9 + 6 * k] for k in range(n_freqs)]
    blocked = np.concatenate([dpe[:, :3]] + sins + coss, axis=1).T
    sx, cx = _pe_fwd(jnp.asarray(x.T), n_freqs)
    want = np.asarray(_pe_bwd(sx, cx, jnp.asarray(blocked), n_freqs)).T
    got = fm.pe_backward(torch.from_numpy(x), torch.from_numpy(dpe), n_freqs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_pe_backward_is_the_adjoint_of_the_recurrence():
    """Against autograd through ``positional_encoding_recurrence``."""
    from sinnerf_tpu_torch.core.encoding import positional_encoding_recurrence

    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(scale=2.0, size=(100, 3)), dtype=torch.float32, requires_grad=True)
    dpe = torch.tensor(rng.normal(size=(100, 63)), dtype=torch.float32)
    positional_encoding_recurrence(x, 10).backward(dpe)
    got = fm.pe_backward(x.detach(), dpe, 10)
    torch.testing.assert_close(got, x.grad, rtol=1e-5, atol=1e-5 * float(x.grad.abs().max()))


def test_plain_backward_matches_autograd(params):
    """The explicit plain backward against autograd through the plain
    forward (float32, the same arithmetic: relative L2 1e-5), and chunked
    into 64 points against itself whole on the parameters."""
    xyz, dirs, g = (torch.from_numpy(a) for a in _points(N, False, seed=5))
    model = nerf_from_state(state_dict_from_jax(params))
    packed = fm.pack_tensors(fm.param_tensors(model), torch.float32, differentiable=True)
    x, d = xyz.clone().requires_grad_(), dirs.clone().requires_grad_()
    fm.nerf_mlp_plain(packed, x, d).backward(g)
    want = [p.grad for p in fm.param_tensors(model)] + [x.grad, d.grad]
    dw, db, dx, dd = fm.nerf_mlp_backward_plain(fm.pack_weights(model, torch.float32), xyz, dirs, g)
    for a, b in zip(list(fm.unpack_grads(dw, db)) + [dx, dd], want):
        assert float((a - b).norm() / b.norm()) < 1e-5


def test_sigma_only_returns_no_direction_gradient(params):
    xyz, _, g = (torch.from_numpy(a) for a in _points(40, True))
    xyz.requires_grad_()
    model = nerf_from_state(state_dict_from_jax(params))
    out = fm.fused_nerf_mlp(model, xyz, None, sigma_only=True)
    assert out.shape == (40, 1)
    out.backward(g)
    assert xyz.grad is not None and model.rgb[0].weight.grad.abs().max() == 0


def test_wrapper_checks_its_inputs(params):
    model = nerf_from_state(state_dict_from_jax(params))
    xyz = torch.zeros(8, 3)
    with pytest.raises(ValueError):
        fm.fused_nerf_mlp(model, xyz, None)  # directions needed
    with pytest.raises(ValueError):
        fm.fused_nerf_mlp(model, xyz.double(), xyz.double())
    with pytest.raises(ValueError):
        fm.fused_nerf_mlp(model, xyz[:, :2], xyz[:, :2])


def test_cpu_wrapper_does_not_count_launches(params):
    before = fm.launch_mlp_fwd.launches, fm.launch_mlp_bwd.launches
    _port(params, "float32", False)
    assert (fm.launch_mlp_fwd.launches, fm.launch_mlp_bwd.launches) == before


# --------------------------------------------------------------------------
# K1's backward through K4
# --------------------------------------------------------------------------

S, K, N_RAYS = 8, 8, 24
# (largest difference over the leaf's largest entry, relative L2)
MASK_FREE_BAND = (1e-4, 1e-4)  # leaves whose gradient passes no ReLU mask of the trunk
TRUNK_BAND = (5e-2, 1e-2)  # a mask that flips between the packages moves one unit's delta


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(scale=0.3, size=(n, 3))
    d = rng.normal(scale=0.3, size=(n, 3)) + [0.0, 0.0, -1.0]
    return np.concatenate([o, d, np.full((n, 1), 2.0), np.full((n, 1), 6.0)], 1).astype(np.float32)


def _det(module, **kw):
    return module.RenderSettings(n_samples=S, n_importance=K, perturb=0.0, noise_std=0.0, white_back=True,
                                 mlp_impl="pallas", **kw)


def _loss(out, target, xp):
    return (xp.sum((out["rgb_fine"] - target) ** 2) + xp.sum((out["rgb_coarse"] - target) ** 2)
            + 0.1 * xp.sum(out["depth_fine"] ** 2) + 0.01 * xp.sum(out["opacity_coarse"] ** 2))


def test_deterministic_kernel_render_gradient_matches_jax():
    """The deterministic render on the kernel path is differentiable, and its
    gradients for both models' parameters and for the rays are JAX's
    ``fused_render_level`` VJP (``fused_render_t.py:222-240``)."""
    level = {"coarse": _params(82), "fine": _params(83)}
    rays = _rays(N_RAYS, 84)
    target = np.random.default_rng(85).uniform(size=(N_RAYS, 3)).astype(np.float32)

    def jax_loss(p, r):
        return _loss(jax_renderer.render_rays(p, r, None, _det(jax_renderer)), jnp.asarray(target), jnp)

    gp, gr = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(jax.tree_util.tree_map(jnp.asarray, level), jnp.asarray(rays))
    models = {k: nerf_from_state(state_dict_from_jax(v)) for k, v in level.items()}
    r = torch.from_numpy(rays).requires_grad_()
    out = port_renderer.render_rays(models, r, _det(port_renderer))
    assert out["rgb_fine"].requires_grad and out["rgb_coarse"].requires_grad
    _loss(out, torch.from_numpy(target), torch).backward()
    want_r = np.asarray(gr)
    np.testing.assert_allclose(r.grad.numpy() / np.abs(want_r).max(), want_r / np.abs(want_r).max(), rtol=0, atol=1e-3)
    for lvl, model in models.items():
        want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, gp[lvl]))
        for name, p in model.state_dict(keep_vars=True).items():
            w, g = want[name].numpy(), p.grad.numpy()
            assert np.abs(w).max() > 0, (lvl, name)
            err = (np.abs(g - w).max() / np.abs(w).max(), np.linalg.norm(g - w) / np.linalg.norm(w))
            mask_free = name.split(".")[0] in ("xyz_encoding_final", "sigma", "dir_encoding", "rgb")
            band = MASK_FREE_BAND if mask_free else TRUNK_BAND
            assert err[0] < band[0] and err[1] < band[1], (lvl, name, err, band)


def test_k1_backward_reaches_rays_and_depths_and_keeps_the_forward():
    """``fused_render_level`` directly: its outputs are the plain version's,
    and with ``needs_input_grad`` set it returns gradients for the rays and
    the depths that match autograd through the recompute."""
    model = nerf_from_state(state_dict_from_jax(_params(86)))
    rng = np.random.default_rng(87)
    rays = torch.from_numpy(_rays(16, 88)[:, :6])
    z = torch.tensor(np.sort(rng.uniform(2, 6, size=(16, 12)), axis=1), dtype=torch.float32)
    plain = fr.render_level_plain(model, rays, z, True, True)
    r, zz = rays.clone().requires_grad_(), z.clone().requires_grad_()
    out = fr.fused_render_level(model, r, zz, True, True)
    for a, b in zip(out, plain):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)
    (out[0].sum() + 0.1 * out[1].sum() + out[2].pow(2).sum()).backward()
    r2, z2 = rays.clone().requires_grad_(), z.clone().requires_grad_()
    again = fr.render_level_recompute(fm.param_tensors(model), r2, z2, True, True, "float32")
    (again[0].sum() + 0.1 * again[1].sum() + again[2].pow(2).sum()).backward()
    torch.testing.assert_close(r.grad, r2.grad)
    torch.testing.assert_close(zz.grad, z2.grad)


def test_detached_parameters_get_no_gradient():
    model = nerf_from_state(state_dict_from_jax(_params(89)))
    rays = torch.from_numpy(_rays(8, 90))
    z = torch.linspace(2, 6, 6).expand(8, 6).contiguous()
    out = fr.fused_render_level(model, rays, z, detach_params=True)
    assert not any(o.requires_grad for o in out)


# --------------------------------------------------------------------------
# chip_smoke.py's K4 limits: another sum order passes, a planted fault fails
# --------------------------------------------------------------------------


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fault", [None, "no input-gradient chain"])
def test_k4_limits_fail_a_broken_pe_adjoint(params, compute_dtype, fault, monkeypatch):
    """The limits ``chip_smoke.py`` holds K4-bwd to, on the CPU, at its
    smallest shape (20001 points): the plain backward summed in chunks of 64
    points passes them; a PE adjoint that drops the recurrence's chain terms
    fails them (the direction input gradient loses most of its signal)."""
    n = 20001
    rng = np.random.default_rng(91)
    xyz = torch.tensor(rng.normal(scale=2.0, size=(n, 3)), dtype=torch.float32)
    dirs = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    g = torch.tensor(rng.normal(size=(n, 4)), dtype=torch.float32)
    model = nerf_from_state(state_dict_from_jax(params))
    packed = fm.pack_weights(model, fm.torch_dtype(compute_dtype))
    want = fm.nerf_mlp_backward_plain(packed, xyz, dirs, g)
    if fault:
        def pe_backward(x, dpe, n_freqs):  # the exact levels only, no chain
            c = x.shape[-1]
            dx = dpe[:, :c].float()
            for k in range(0, n_freqs, 4):
                xk = x.float() * 2.0**k
                ds, dc = dpe[:, c + 2 * c * k : 2 * c + 2 * c * k], dpe[:, 2 * c + 2 * c * k : 3 * c + 2 * c * k]
                dx = dx + 2.0**k * (torch.cos(xk) * ds - torch.sin(xk) * dc)
            return dx

        monkeypatch.setattr(fm, "pe_backward", pe_backward)
    got = fm.nerf_mlp_backward_plain(packed, xyz, dirs, g, chunk=64)
    params_err = chip_smoke.grad_errors(fm.unpack_grads(*got[:2]), fm.unpack_grads(*want[:2]))
    l2 = max(params_err[1], chip_smoke.input_grad_error(got[2], want[2])[1],
             chip_smoke.input_grad_error(got[3], want[3])[1])
    tol = chip_smoke.K4_BWD_TOL
    if fault is None:
        assert params_err[0] <= tol[0] and l2 <= tol[1], (params_err, l2)
    else:
        assert l2 > tol[1], l2


def test_k4_gradient_band_is_one_input_ulp(params):
    """Where ``chip_smoke.K4_BWD_TOL`` comes from, in float32: on the inputs
    of ``test_k4_kernels_match_plain[float32-20001-False]`` (whose card
    reading is 2.7e-2 / 6.6e-3), moving xyz by one float32 ulp moves the
    plain backward's worst leaf by 2.8e-2 / 1.1e-2: past the first limit
    (1e-2, 5e-3), inside the present one.  One ulp of xyz, amplified by the
    PE (up to 2^9 x), flips a few ReLU masks; the kernel's other sum orders
    flip them too."""
    n = 20001
    rng = np.random.default_rng(n)
    xyz = torch.tensor(rng.normal(scale=2.0, size=(n, 3)), dtype=torch.float32)
    dirs = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    g = torch.tensor(rng.normal(size=(n, 4)), dtype=torch.float32)
    packed = fm.pack_weights(nerf_from_state(state_dict_from_jax(params)), torch.float32)
    want = fm.nerf_mlp_backward_plain(packed, xyz, dirs, g)
    got = fm.nerf_mlp_backward_plain(packed, torch.nextafter(xyz, torch.full_like(xyz, np.inf)), dirs, g)
    leaf_max, leaf_l2 = chip_smoke.grad_errors(fm.unpack_grads(*got[:2]), fm.unpack_grads(*want[:2]))
    l2 = max(leaf_l2, chip_smoke.input_grad_error(got[2], want[2])[1], chip_smoke.input_grad_error(got[3], want[3])[1])
    assert leaf_max > 1e-2, (leaf_max, l2)
    assert leaf_max <= chip_smoke.K4_BWD_TOL[0] and l2 <= chip_smoke.K4_BWD_TOL[1], (leaf_max, l2)


# --------------------------------------------------------------------------
# on the card: the kernels against the plain versions
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,sigma_only", [(20001, False), (20001, True), (70001, False), (333, False), (333, True)])
def test_k4_kernels_match_plain(cuda_device, params, n, sigma_only, compute_dtype):
    """333 points, a short tail of less than one tile, is held to
    ``chip_smoke.K4_BWD_TOL_SHORT``; the others to ``K4_BWD_TOL``."""
    rng = np.random.default_rng(n)
    xyz = torch.tensor(rng.normal(scale=2.0, size=(n, 3)), dtype=torch.float32, device=cuda_device)
    dirs = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device=cuda_device)
    g = torch.tensor(rng.normal(size=(n, 1 if sigma_only else 4)), dtype=torch.float32, device=cuda_device)
    model = nerf_from_state(state_dict_from_jax(params)).to(cuda_device)
    before = fm.launch_mlp_fwd.launches, fm.launch_mlp_bwd.launches
    chip_smoke.k4_check(model, xyz, dirs, g, compute_dtype, sigma_only, "K4")  # raises Failed
    assert (fm.launch_mlp_fwd.launches, fm.launch_mlp_bwd.launches) == (before[0] + 1, before[1] + 2)


@pytest.mark.cuda
def test_k1_backward_on_the_card(cuda_device):
    """K1's backward on CUDA tensors: one K4-fwd and one K4-bwd launch per
    level, gradients close to the plain path's."""
    level = {"coarse": _params(82), "fine": _params(83)}
    rays = torch.from_numpy(_rays(4096, 84)).to(cuda_device)
    target = torch.rand(4096, 3, device=cuda_device)
    grads = {}
    for impl in ("pallas", "xla"):
        models = {k: nerf_from_state(state_dict_from_jax(v)).to(cuda_device) for k, v in level.items()}
        before = fm.launch_mlp_fwd.launches, fm.launch_mlp_bwd.launches
        settings = port_renderer.RenderSettings(n_samples=64, n_importance=128, perturb=0.0, noise_std=0.0,
                                                white_back=True, mlp_impl=impl)
        _loss(port_renderer.render_rays(models, rays, settings), target, torch).backward()
        torch.cuda.synchronize()
        if impl == "pallas":
            assert (fm.launch_mlp_fwd.launches, fm.launch_mlp_bwd.launches) == (before[0] + 2, before[1] + 2)
        grads[impl] = [p.grad for m in models.values() for p in m.parameters()]
    err = chip_smoke.grad_errors(grads["pallas"], grads["xla"])
    tol = chip_smoke.STEP_GRAD_TOL["float32"]
    assert err[0] <= tol[0] and err[1] <= tol[1], err
