"""The renderer's remaining branches and the deterministic training step
against the JAX package on the CPU.

``test_time`` (a sigma-only coarse level through K4), ``fast_eval=False``
and ``fast_train=False`` (K4 and ``composite``), ``fast_merge=False``
(``sample_pdf`` with iid ``u`` and a sort), ``eval_points``, and
``compute_losses``/``train_step`` with ``perturb=0, noise_std=0`` on the
kernel path (K1, whose backward recomputes through K4).  The kernels run
their plain versions here and JAX's run in interpret mode; random draws are
made in JAX from the key its ``render_rays`` is given (split as
``renderer.py:234`` splits it) and fed to the port.  JAX references are
jitted, in float32.

Tolerances.  Renders: rtol/atol 1e-4, as ``tests/test_torch_train_step.py``
holds the stochastic kernel render (measured up to 2e-6).  Gradients per
leaf, as (largest difference over the leaf's largest entry, relative L2):
the leaves that pass no ReLU mask of the trunk (final, sigma, direction,
rgb) (1e-4, 1e-4); the trunk leaves (1e-1, 3e-2), the band of a mask that
flips between the packages (``tests/test_torch_train_step.py``; measured up
to 1.5e-2 / 1.1e-2); the rays by relative L2, 3e-2 (measured up to
1.03e-2): each ray's gradient stands alone, so a flipped mask moves that
ray's whole gradient.  ``compute_losses``: the total and every metric rtol
1e-4, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sinnerf_tpu.render import renderer as jax_renderer
from sinnerf_tpu.train import step as jax_step
from sinnerf_tpu_torch.models.nerf import nerf_from_state, random_params, state_dict_from_jax
from sinnerf_tpu_torch.render import renderer as port_renderer
from sinnerf_tpu_torch.train import optimizers as port_optimizers
from sinnerf_tpu_torch.train import step as port_step

N, S, K = 40, 8, 8
MASK_FREE_BAND = (1e-4, 1e-4)
TRUNK_BAND = (1e-1, 3e-2)
RAY_L2 = 3e-2


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
def level_params():
    return {"coarse": _params(101), "fine": _params(102)}


def _models(level_params):
    return {k: nerf_from_state(state_dict_from_jax(v)) for k, v in level_params.items()}


def _rays(rng, n):
    o = rng.normal(scale=0.3, size=(n, 3))
    d = rng.normal(scale=0.3, size=(n, 3)) + [0.0, 0.0, -1.0]
    return np.concatenate([o, d, np.full((n, 1), 2.0), np.full((n, 1), 6.0)], 1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@jax.jit
def _draws(key):
    k_perturb, k_noise_c, k_pdf, k_noise_f = jax.random.split(key, 4)
    return (jax.random.uniform(k_perturb, (N, S)), jax.random.normal(k_noise_c, (N, S)),
            jax.random.uniform(k_pdf, (N, K)), jax.random.normal(k_noise_f, (N, S + K)))


def _settings(module, **kw):
    base = dict(n_samples=S, n_importance=K, perturb=1.0, noise_std=1.0, white_back=True, mlp_impl="pallas")
    return module.RenderSettings(**{**base, **kw})


def _loss(out, target, xp):
    total = 0.01 * xp.sum(out["opacity_coarse"] ** 2)
    if "rgb_coarse" in out:
        total = total + xp.sum((out["rgb_coarse"] - target) ** 2)
    return total + xp.sum((out["rgb_fine"] - target) ** 2) + 0.1 * xp.sum(out["depth_fine"] ** 2)


def _leaf_band(leaf):
    return MASK_FREE_BAND if leaf.split(".")[0] in ("xyz_encoding_final", "sigma", "dir_encoding", "rgb") else TRUNK_BAND


def _check_grads(models, want_params):
    for level, model in models.items():
        want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, want_params[level]))
        for name, p in model.state_dict(keep_vars=True).items():
            w = want[name].numpy()
            if not np.abs(w).max() > 0:  # a sigma-only level: no gradient reaches its rgb branch
                assert p.grad is None or not bool(p.grad.abs().max() > 0), (level, name)
                continue
            g = p.grad.numpy()
            err = (np.abs(g - w).max() / np.abs(w).max(), np.linalg.norm(g - w) / np.linalg.norm(w))
            band = _leaf_band(name)
            assert err[0] < band[0] and err[1] < band[1], (level, name, err, band)


BRANCHES = {
    # name: RenderSettings fields; every case also on the plain path
    "test_time": dict(test_time=True),
    "no_fast_eval_train_det": dict(perturb=0.0, noise_std=0.0, fast_eval=False, fast_train=False),
    "no_fast_train": dict(fast_train=False),
    "no_fast_merge": dict(fast_merge=False),
    "no_fast_merge_det": dict(perturb=0.0, noise_std=0.0, fast_merge=False),
}


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("name", sorted(BRANCHES))
def test_branch_matches_jax(level_params, name, impl):
    """Outputs, and the parameter and ray gradients, of each branch."""
    rng = np.random.default_rng(103)
    rays, target = _rays(rng, N), rng.uniform(size=(N, 3)).astype(np.float32)
    key = jax.random.key(104)
    fields = dict(BRANCHES[name], mlp_impl=impl)

    def jax_run(p, r):
        out = jax_renderer.render_rays(p, r, key, _settings(jax_renderer, **fields))
        return _loss(out, jnp.asarray(target), jnp), out

    (_, want), (gp, gr) = jax.jit(jax.value_and_grad(jax_run, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, level_params), jnp.asarray(rays))
    models = _models(level_params)
    r = _t(rays).requires_grad_()
    got = port_renderer.render_rays(models, r, _settings(port_renderer, **fields), *(_t(np.array(a)) for a in _draws(key)))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(v), rtol=1e-4, atol=1e-4, err_msg=k)
    _loss(got, _t(target), torch).backward()
    _check_grads(models, gp)
    stochastic_fused = impl == "pallas" and fields.get("fast_train", True) and (
        fields.get("perturb", 1.0) > 0 or fields.get("noise_std", 1.0) > 0 or fields.get("test_time"))
    if stochastic_fused:  # K3 levels: rays and depths are data (JAX stops their gradients too)
        return
    want_r = np.asarray(gr)
    assert np.abs(want_r).max() > 0
    assert np.linalg.norm(r.grad.numpy() - want_r) / np.linalg.norm(want_r) < RAY_L2


def test_test_time_without_importance_returns_the_coarse_weights_only(level_params):
    settings = _settings(port_renderer, test_time=True, n_importance=0, perturb=0.0)
    out = port_renderer.render_rays(_models(level_params), _t(_rays(np.random.default_rng(1), 8)), settings)
    assert set(out) == {"opacity_coarse"}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_eval_points_matches_jax(level_params, compute_dtype):
    pts = np.random.default_rng(105).normal(size=(77, 3)).astype(np.float32)
    want = jax_renderer.eval_points(jax.tree_util.tree_map(jnp.asarray, level_params), jnp.asarray(pts),
                                    jax_renderer.RenderSettings(compute_dtype=compute_dtype))
    got = port_renderer.eval_points(_models(level_params), _t(pts), port_renderer.RenderSettings(
        compute_dtype=compute_dtype))
    assert got.shape == (77, 1)
    tol = 1e-5 if compute_dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


# --------------------------------------------------------------------------
# the deterministic training step on the kernel path
# --------------------------------------------------------------------------

N_RAND, PS = 32, 6


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(106)

    def pos(*shape):
        return rng.uniform(2.0, 6.0, size=shape).astype(np.float32)

    return {
        "rays": _rays(rng, N_RAND)[None],
        "rgbs": rng.uniform(size=(1, N_RAND, 3)).astype(np.float32),
        "depth": pos(1, N_RAND, 1),
        "rays_proj": _rays(rng, N_RAND)[None],
        "depth_proj": pos(1, N_RAND, 1),
        "real_patch": rng.uniform(size=(1, 3, PS, PS)).astype(np.float32),
        "rays_full": _rays(rng, PS * PS)[None],
        "warp_patch": rng.uniform(size=(1, 3, PS, PS)).astype(np.float32),
        "warp_patch_depth": pos(1, PS * PS, 1) * (rng.uniform(size=(1, PS * PS, 1)) > 0.5),
        "depth_ray": _rays(rng, PS * PS)[None],
        "depth_gt": pos(1, PS * PS, 1),
        "depth_ray_rgb": rng.uniform(size=(1, PS * PS, 3)).astype(np.float32),
    }


def _det_fields():
    return dict(dataset_name="llff_ray_patch_1image_proj", depth_weight=8.0, proj_weight=1.0, depth_smooth_weight=0.5)


def test_deterministic_compute_losses_matches_jax(level_params, batch):
    """``compute_losses`` with ``perturb=0, noise_std=0`` on the kernel path:
    the total, every metric, and the leaf-wise gradients (K1's backward
    through K4) against JAX's, whose K1 VJP recomputes through its K4."""
    settings = dict(perturb=0.0, noise_std=0.0)
    cfg = jax_step.TrainConfig(render=_settings(jax_renderer, **settings), imsize=PS, **_det_fields())

    def loss(p):
        total, aux = jax_step.compute_losses(p, None, None, None, None, {k: jnp.asarray(v) for k, v in batch.items()},
                                             jax.random.key(107), jnp.asarray(0.0), cfg)
        return total, aux["metrics"]

    (total, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, level_params))
    models = _models(level_params)
    pcfg = port_step.TrainConfig(render=_settings(port_renderer, **settings), **_det_fields())
    got, aux = port_step.compute_losses(models, {k: _t(v) for k, v in batch.items()}, pcfg)
    np.testing.assert_allclose(got.item(), float(total), rtol=1e-4)
    assert set(aux["metrics"]) == set(metrics)
    for tag, v in metrics.items():
        np.testing.assert_allclose(aux["metrics"][tag].numpy(), np.asarray(v), rtol=1e-4, atol=1e-5, err_msg=tag)
    got.backward()
    _check_grads(models, grads)


def test_deterministic_train_steps_lower_the_loss(level_params, batch):
    """Three ``train_step``s with Adam on the kernel path: the loss falls, as
    on the plain path (rtol 1e-5)."""
    import argparse

    hp = argparse.Namespace(optimizer="adam", lr=2e-4, momentum=0.9, weight_decay=0.0)
    losses = {}
    for impl in ("pallas", "xla"):
        models = _models(level_params)
        state = port_step.TrainState(models=models, opt_g=port_optimizers.get_optimizer(
            hp, [p for m in models.values() for p in m.parameters()]))
        cfg = port_step.TrainConfig(render=_settings(port_renderer, perturb=0.0, noise_std=0.0, mlp_impl=impl),
                                    **_det_fields())
        seq = []
        for _ in range(3):
            state, aux = port_step.train_step(state, {k: _t(v) for k, v in batch.items()}, cfg)
            seq.append(aux["metrics"]["train/loss"].item())
        losses[impl] = seq
    assert all(b < a for a, b in zip(losses["pallas"], losses["pallas"][1:])), losses
    np.testing.assert_allclose(losses["pallas"], losses["xla"], rtol=1e-5)
