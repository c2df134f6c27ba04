"""The port's training step against the JAX package on the CPU: metrics and
losses, the stochastic render on the kernel path, ``compute_losses``, Adam
steps, schedules.

Random draws are made in JAX from the key the JAX function is given (split as
``train/step.py:133`` and ``render/renderer.py:234`` split it) and fed to the
port as tensors.  JAX references are jitted once per module.

Tolerances.  Metrics and losses: 1e-6 elementwise (the same float32
arithmetic; SSIM 1e-5: two convolution orders).  Renders: rtol/atol 1e-4.
``compute_losses``: the total and every metric rtol 1e-4 (atol 1e-5).
Gradients are held per leaf, as the largest difference over the leaf's
largest entry and as relative L2, in two groups:

* the leaves whose gradient passes no ReLU mask (``xyz_encoding_final``,
  ``sigma``, ``dir_encoding``, ``rgb``): 1e-4 (measured up to 2.5e-5).  Their
  gradients run through every loss term, the composite's adjoint and the
  detached resampling, so a fault in any of those shows here;
* the eight trunk layers: 1e-2, and 1e-1 / 3e-2 under the dtu losses
  (measured up to 5.2e-3 / 3.4e-3, and 5.0e-2 / 1.1e-2 under dtu, whose coarse
  gradient is smallest).  That band is ReLU masks, not arithmetic: a
  pre-activation that lies within rounding of zero falls on either side, and
  a flipped mask changes one unit's delta at one point by its whole size,
  through every layer below.  ``test_trunk_band_is_the_batch_conditioning``
  shows it: the port's own trunk gradients move as far when the sample
  depths move by one float32 ulp, while the loss and the mask-free leaves
  stay put, and the port is held to differ from JAX by no more than 3x that.

Optimizers on the same gradients: rtol 1e-6; through ``train_step``: see
``test_three_steps_match_optax``.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sinnerf_tpu.losses import depth as jax_depth
from sinnerf_tpu.losses import photometric as jax_photo
from sinnerf_tpu.render import renderer as jax_renderer
from sinnerf_tpu.train import optimizers as jax_optimizers
from sinnerf_tpu.train import step as jax_step
from sinnerf_tpu.utils import metrics as jax_metrics
from sinnerf_tpu_torch.losses import depth as port_depth
from sinnerf_tpu_torch.losses import photometric as port_photo
from sinnerf_tpu_torch.models.nerf import jax_from_state_dict, nerf_from_state, random_params, state_dict_from_jax
from sinnerf_tpu_torch.render import renderer as port_renderer
from sinnerf_tpu_torch.train import optimizers as port_optimizers
from sinnerf_tpu_torch.train import step as port_step
from sinnerf_tpu_torch.utils import metrics as port_metrics

N_RAND, PS, S, K = 64, 8, 8, 8  # rays per bundle, patch side, coarse and importance samples
N_ALL = 2 * N_RAND + 2 * PS * PS


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --------------------------------------------------------------------------
# metrics and losses
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(60)
    return rng.uniform(size=(2, 3, 16, 16)).astype(np.float32), rng.uniform(size=(2, 3, 16, 16)).astype(np.float32)


METRIC_CASES = {
    "mse": (lambda m, a, b, k: m.mse(a, b), 1e-6),
    "mse_masked": (lambda m, a, b, k: m.mse(a, b, a > 0.5), 1e-6),
    "mse_empty_mask": (lambda m, a, b, k: m.mse(a, b, a > 2.0), 1e-6),
    "psnr": (lambda m, a, b, k: m.psnr(a, b), 1e-5),
    "ssim_map_11": (lambda m, a, b, k: m.ssim_map(a, b, 11), 1e-5),
    "ssim_map_3": (lambda m, a, b, k: m.ssim_map(a, b, 3), 1e-5),
    "ssim": (lambda m, a, b, k: m.ssim(a, b), 1e-5),
    "dssim_loss": (lambda m, a, b, k: m.dssim_loss(a, b), 1e-5),
}


@pytest.mark.parametrize("name", sorted(METRIC_CASES))
def test_metrics_match_jax(images, name):
    fn, tol = METRIC_CASES[name]
    a, b = images
    want = np.asarray(fn(jax_metrics, jnp.asarray(a), jnp.asarray(b), jnp))
    got = fn(port_metrics, _t(a), _t(b), torch).numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _depth_inputs():
    rng = np.random.default_rng(61)
    pred = rng.uniform(0, 8, size=(3, 40)).astype(np.float32)
    target = rng.uniform(0, 8, size=(3, 40)).astype(np.float32)
    target[rng.uniform(size=target.shape) < 0.3] = 0.0
    target[1] = 0.0  # an item whose default mask is empty
    return pred, target


DEPTH_CASES = {
    "smooth_l1": lambda m, p, t: m.smooth_l1(p, t),
    "smooth_l1_beta": lambda m, p, t: m.smooth_l1(p, t, 0.5),
    "masked_default": lambda m, p, t: m.smooth_l1_masked(p, t),
    "masked_off": lambda m, p, t: m.smooth_l1_masked(p, t, use_mask=False),
    "masked_given": lambda m, p, t: m.smooth_l1_masked(p, t, mask=p > 4),
    "masked_empty": lambda m, p, t: m.smooth_l1_masked(p, t, mask=p > 100),
    "per_item_default": lambda m, p, t: m.smooth_l1_masked_per_item(p, t),
    "per_item_off": lambda m, p, t: m.smooth_l1_masked_per_item(p, t, use_mask=False),
    "per_item_given": lambda m, p, t: m.smooth_l1_masked_per_item(p, t, mask=t == 0),
    "per_item_empty": lambda m, p, t: m.smooth_l1_masked_per_item(p, t, mask=p > 100),
}


@pytest.mark.parametrize("name", sorted(DEPTH_CASES))
def test_depth_losses_match_jax(name):
    pred, target = _depth_inputs()
    want = np.asarray(DEPTH_CASES[name](jax_depth, jnp.asarray(pred), jnp.asarray(target)))
    got = DEPTH_CASES[name](port_depth, _t(pred), _t(target)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_depth_smoothness_matches_jax(images):
    img, other = images
    idepth = other[:, :1] * 5
    want = np.asarray(jax_depth.inverse_depth_smoothness_loss(jnp.asarray(idepth), jnp.asarray(img)))
    got = port_depth.inverse_depth_smoothness_loss(_t(idepth), _t(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["mse", "l2_ssim"])
@pytest.mark.parametrize("with_fine", [True, False])
def test_photometric_losses_match_jax(images, name, with_fine):
    a, b = images
    inputs = {"rgb_coarse": a, "rgb_fine": a[::-1].copy()} if with_fine else {"rgb_coarse": a}
    want = jax_photo.loss_dict[name]({k: jnp.asarray(v) for k, v in inputs.items()}, jnp.asarray(b))
    got = port_photo.loss_dict[name]({k: _t(v) for k, v in inputs.items()}, _t(b))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)


# --------------------------------------------------------------------------
# the render and the step
# --------------------------------------------------------------------------


def _params(seed):
    p = random_params(np.random.default_rng(seed))
    p["sigma"]["b"] = p["sigma"]["b"] + np.float32(0.3)  # a partly opaque field
    return p


@pytest.fixture(scope="module")
def level_params():
    return {"coarse": _params(70), "fine": _params(71)}


def _models(level_params):
    return {k: nerf_from_state(state_dict_from_jax(v)) for k, v in level_params.items()}


def _rays(rng, n):
    o = rng.normal(scale=0.3, size=(n, 3))
    d = rng.normal(scale=0.3, size=(n, 3)) + [0.0, 0.0, -1.0]
    return np.concatenate([o, d, np.full((n, 1), 2.0), np.full((n, 1), 6.0)], 1).astype(np.float32)


@pytest.fixture(scope="module")
def batch():
    """One fixed batch with the sampler's schema (``bench.py:123-136``)."""
    rng = np.random.default_rng(72)

    def f(a):
        return np.asarray(a, dtype=np.float32)

    def pos(*shape):
        return rng.uniform(2.0, 6.0, size=shape)

    depth_gt = pos(1, PS * PS, 1)
    depth_gt[:, ::5] = 0.0  # background pixels, for the blender branch
    return {
        "rays": _rays(rng, N_RAND)[None],
        "rgbs": f(rng.uniform(size=(1, N_RAND, 3))),
        "depth": f(pos(1, N_RAND, 1)),
        "rays_proj": _rays(rng, N_RAND)[None],
        "depth_proj": f(pos(1, N_RAND, 1)),
        "real_patch": f(rng.uniform(size=(1, 3, PS, PS))),
        "rays_full": _rays(rng, PS * PS)[None],
        "warp_patch": f(rng.uniform(size=(1, 3, PS, PS)) * (rng.uniform(size=(1, 1, PS, PS)) > 0.3)),
        "warp_patch_depth": f(pos(1, PS * PS, 1) * (rng.uniform(size=(1, PS * PS, 1)) > 0.5)),
        "depth_ray": _rays(rng, PS * PS)[None],
        "depth_gt": f(depth_gt),
        "depth_ray_rgb": f(rng.uniform(size=(1, PS * PS, 3))),
    }


@jax.jit
def _render_draws(key):
    """The draws ``render_rays`` makes from its key (``renderer.py:234``)."""
    k_perturb, k_noise_c, k_pdf, k_noise_f = jax.random.split(key, 4)
    return (jax.random.uniform(k_perturb, (N_ALL, S)), jax.random.normal(k_noise_c, (N_ALL, S)),
            jax.random.uniform(k_pdf, (N_ALL, K)), jax.random.normal(k_noise_f, (N_ALL, S + K)))


def _port_draws(render_key):
    return port_step.RenderDraws(*(_t(np.array(a)) for a in _render_draws(render_key)))


def _settings(module, mlp_impl, **kw):
    return module.RenderSettings(n_samples=S, n_importance=K, perturb=1.0, noise_std=1.0, white_back=True,
                                 mlp_impl=mlp_impl, **kw)


def test_stochastic_kernel_render_matches_jax_pallas(level_params, batch):
    """``render_rays`` on the kernel path with perturb, noise and pdf draws
    (the plain versions of K3 and K2 on the CPU) against JAX's train
    kernels in interpret mode on the draws its key gives."""
    rays = np.concatenate([batch[k].reshape(-1, 8) for k in ("rays", "depth_ray", "rays_full", "rays_proj")])
    key = jax.random.key(5)
    want = jax.jit(jax_renderer.render_rays, static_argnums=3)(
        jax.tree_util.tree_map(jnp.asarray, level_params), jnp.asarray(rays), key, _settings(jax_renderer, "pallas"))
    with torch.no_grad():
        got = port_renderer.render_rays(_models(level_params), _t(rays), _settings(port_renderer, "pallas"),
                                        *_port_draws(key))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-4, atol=1e-4, err_msg=name)


def test_detach_coarse_stops_the_coarse_gradient(level_params, batch):
    rays = _t(batch["rays"][0])
    for impl in port_renderer.MLP_IMPLS:
        models = _models(level_params)
        settings = _settings(port_renderer, impl, detach_coarse=True)
        out = port_renderer.render_rays(models, rays, settings, generator=torch.Generator().manual_seed(1))
        assert not out["rgb_coarse"].requires_grad
        (out["rgb_fine"].sum() + out["depth_fine"].sum()).backward()
        assert all(p.grad is None for p in models["coarse"].parameters())
        assert all(p.grad is not None for p in models["fine"].parameters())


LOSS_CASES = {
    # name: (mlp_impl, TrainConfig fields, epoch, trunk band (max over largest entry, relative L2))
    "kernels_blender": ("pallas", dict(depth_weight=8.0, proj_weight=1.0, depth_smooth_weight=0.5), 0.0, (1e-2, 1e-2)),
    "plain_dtu_ssim": ("xla", dict(dataset_name="dtu_proj", patch_loss="l2_ssim", depth_weight=8.0,
                                   depth_smooth_weight=0.5), 0.0, (1e-1, 3e-2)),
    "plain_llff_anneal": ("xla", dict(dataset_name="llff_proj", depth_weight=8.0, proj_weight=0.5,
                                      depth_anneal=True), 10.0, (1e-2, 1e-2)),
}
MASK_FREE_BAND = (1e-4, 1e-4)
ULP = 2e-7  # a relative nudge that moves a float32 by one or two ulps


@pytest.fixture(scope="module")
def jax_losses(level_params, batch):
    out = {}
    for name, (impl, fields, epoch, _) in LOSS_CASES.items():
        cfg = jax_step.TrainConfig(render=_settings(jax_renderer, impl), imsize=PS, **fields)

        def loss(p, key, cfg=cfg, epoch=epoch):
            total, aux = jax_step.compute_losses(p, None, None, None, None, {k: jnp.asarray(v) for k, v in batch.items()},
                                                 key, jnp.asarray(epoch), cfg)
            return total, (aux["metrics"], aux["images"])

        (total, (metrics, imgs)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, level_params), jax.random.key(11))
        out[name] = (float(total), {k: np.asarray(v) for k, v in metrics.items()},
                     {k: np.asarray(v) for k, v in imgs.items()}, jax.tree_util.tree_map(np.asarray, grads))
    return out


def _mask_free(leaf):
    """Whether a parameter's gradient passes no ReLU mask of the trunk."""
    return leaf.split(".")[0] in ("xyz_encoding_final", "sigma", "dir_encoding", "rgb")


def _leaf_errors(got, want):
    """{'coarse.<leaf>': (largest difference over the largest entry, relative L2)}."""
    out = {}
    for level in ("coarse", "fine"):
        assert set(got[level]) == set(want[level])
        for leaf, w in want[level].items():
            g = got[level][leaf]
            assert np.abs(w).max() > 0, (level, leaf)
            out[f"{level}.{leaf}"] = (np.abs(g - w).max() / np.abs(w).max(), np.linalg.norm(g - w) / np.linalg.norm(w))
    return out


def _worst(errors, mask_free):
    picked = [e for leaf, e in errors.items() if _mask_free(leaf.split(".", 1)[1]) == mask_free]
    return max(e[0] for e in picked), max(e[1] for e in picked)


@pytest.fixture(scope="module")
def port_losses(level_params, batch):
    """name -> [(total, aux, gradients) as drawn, the same with the stratified
    draws nudged by ``ULP``]."""
    render_key = jax.random.split(jax.random.key(11), 6)[0]  # train/step.py:133,157
    out = {}
    for name, (impl, fields, epoch, _) in LOSS_CASES.items():
        cfg = port_step.TrainConfig(render=_settings(port_renderer, impl), **fields)
        out[name] = []
        for nudge in (0.0, ULP):
            draws = _port_draws(render_key)
            draws = draws._replace(perturb_u=draws.perturb_u * (1.0 + nudge))
            models = _models(level_params)
            total, aux = port_step.compute_losses(models, {k: _t(v) for k, v in batch.items()}, cfg, epoch, draws)
            total.backward()
            grads = {level: {k: p.grad.numpy() for k, p in m.state_dict(keep_vars=True).items()}
                     for level, m in models.items()}
            out[name].append((total.item(), aux, grads))
    return out


def _jax_grads(jax_losses, name):
    return {level: {k: v.numpy() for k, v in state_dict_from_jax(jax_losses[name][3][level]).items()}
            for level in ("coarse", "fine")}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_compute_losses_matches_jax(jax_losses, port_losses, name):
    """The total, every metric tag, the images and the leaf-wise gradients
    on one fixed batch."""
    total, aux, grads = port_losses[name][0]
    want_total, want_metrics, want_images, _ = jax_losses[name]
    np.testing.assert_allclose(total, want_total, rtol=1e-4)
    assert set(aux["metrics"]) == set(want_metrics)
    for tag, v in want_metrics.items():
        np.testing.assert_allclose(aux["metrics"][tag].numpy(), v, rtol=1e-4, atol=1e-5, err_msg=tag)
    assert set(aux["images"]) == set(want_images)
    for tag, v in want_images.items():
        np.testing.assert_allclose(aux["images"][tag].numpy(), v, rtol=1e-4, atol=1e-4, err_msg=tag)
    for leaf, err in _leaf_errors(grads, _jax_grads(jax_losses, name)).items():
        band = MASK_FREE_BAND if _mask_free(leaf.split(".", 1)[1]) else LOSS_CASES[name][3]
        assert err[0] < band[0] and err[1] < band[1], (leaf, err, band)


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_trunk_band_is_the_batch_conditioning(jax_losses, port_losses, name):
    """Where the trunk's band comes from.  Moving the stratified draws by one
    float32 ulp leaves the port's loss and its mask-free gradients where they
    were (a smooth function of the depths), and moves its own trunk gradients
    as far as they lie from JAX's: the masks of pre-activations within
    rounding of zero flip.  So the port is held to differ from JAX by no more
    than 3x what one ulp does to it (measured: 1.0x, 1.0x and 0.5x in the max
    measure, 1.1x, 1.0x and 1.0x in relative L2)."""
    (total, _, grads), (nudged_total, _, nudged_grads) = port_losses[name]
    assert abs(nudged_total - total) < 1e-6 * abs(total)
    own = _leaf_errors(nudged_grads, grads)
    assert max(_worst(own, mask_free=True)) < 1e-4, own
    vs_jax = _worst(_leaf_errors(grads, _jax_grads(jax_losses, name)), mask_free=False)
    own_trunk = _worst(own, mask_free=False)
    assert own_trunk[1] > 1e-3, own_trunk  # one ulp moves a trunk leaf by more than 10x the mask-free band
    assert vs_jax[0] < 3 * own_trunk[0] and vs_jax[1] < 3 * own_trunk[1], (vs_jax, own_trunk)


# --------------------------------------------------------------------------
# optimizers
# --------------------------------------------------------------------------

LR_CASES = [
    dict(lr=2e-4, lr_scheduler="steplr", decay_step=[500, 1000], decay_gamma=0.5),
    dict(lr=1e-3, lr_scheduler="cosine", num_epochs=100),
    dict(lr=1e-3, lr_scheduler="poly", num_epochs=100, poly_exp=0.9),
    dict(lr=1e-3, lr_scheduler="steplr", decay_step=[20], decay_gamma=0.1, warmup_epochs=10, warmup_multiplier=2.0),
    dict(lr=1e-3, lr_scheduler="steplr", decay_step=[20], warmup_epochs=10, warmup_multiplier=2.0, optimizer="radam"),
]


@pytest.mark.parametrize("case", range(len(LR_CASES)))
def test_lr_for_epoch_matches_jax(case):
    hp = argparse.Namespace(**LR_CASES[case])
    for epoch in (0, 1, 5, 10, 11, 19, 20, 31, 50, 99, 100, 499, 500, 1000, 1500):
        assert port_optimizers.lr_for_epoch(hp, epoch) == pytest.approx(jax_optimizers.lr_for_epoch(hp, epoch), rel=1e-12)
    with pytest.raises(ValueError):
        port_optimizers.lr_for_epoch(argparse.Namespace(lr=1e-3, lr_scheduler="nope"), 0)


def _adam_state(opt_state):
    found = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
             if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


def _named_params(models):
    return {f"{level}.{k}": p for level, m in models.items() for k, p in m.named_parameters()}


def _flat_tree(tree):
    """{'coarse': jax layer tree, ...} -> 'coarse.<state dict name>' -> torch-layout numpy."""
    return {f"{level}.{k}": v.numpy() for level, sub in tree.items()
            for k, v in state_dict_from_jax(jax.tree_util.tree_map(np.asarray, sub)).items()}


OPT_CASES = [("adam", 0.0), ("adam", 1e-2), ("sgd", 0.0), ("sgd", 1e-2)]


def _hp(optimizer, weight_decay):
    return argparse.Namespace(optimizer=optimizer, lr=2e-4, momentum=0.9, weight_decay=weight_decay,
                              lr_scheduler="steplr", decay_step=[1], decay_gamma=0.5)


@pytest.mark.parametrize("optimizer,weight_decay", OPT_CASES)
def test_optimizer_steps_match_optax_on_the_same_gradients(optimizer, weight_decay):
    """Three steps of the port's optimizer against optax's on the same
    parameters and the same gradients: the coupled weight decay, the lr fed
    per epoch by ``set_lr``, Adam's bias correction and eps, SGD's momentum.
    Then Adam's moments after step 2 read into a fresh ``torch.optim.Adam``
    give the same third step."""
    hp = _hp(optimizer, weight_decay)
    rng = np.random.default_rng(80)
    p0 = {"a": rng.normal(size=(5, 7)).astype(np.float32), "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 10.0 ** rng.uniform(-6, 1, size=v.shape)).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    opt = jax_optimizers.get_optimizer(hp)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = opt.init(jparams)
    named = {k: torch.nn.Parameter(_t(v.copy())) for k, v in p0.items()}
    popt = port_optimizers.get_optimizer(hp, list(named.values()))
    assert port_optimizers.get_learning_rate(popt) == pytest.approx(jax_optimizers.get_learning_rate(jstate))
    resumed = None
    for step, g in enumerate(grads):
        lr = jax_optimizers.lr_for_epoch(hp, step)
        if step == 2 and optimizer == "adam":  # a fresh optimizer that takes up optax's state
            adam = _adam_state(jstate)
            resumed = {k: torch.nn.Parameter(_t(np.array(v))) for k, v in jparams.items()}
            r_opt = port_optimizers.get_optimizer(hp, list(resumed.values()))
            port_optimizers.load_adam_moments(r_opt, resumed, adam.mu, adam.nu, int(adam.count))
            port_optimizers.set_lr(r_opt, lr)
            for k, p in resumed.items():
                p.grad = _t(g[k].copy())
            r_opt.step()
        jstate = jax_optimizers.set_lr(jstate, lr)
        updates, jstate = opt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        port_optimizers.set_lr(popt, port_optimizers.lr_for_epoch(hp, step))
        assert port_optimizers.get_learning_rate(popt) == pytest.approx(lr)
        for k, p in named.items():
            p.grad = _t(g[k].copy())
        popt.step()
        for k, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step} {k}")
    if optimizer == "adam":
        adam = _adam_state(jstate)
        for k, p in named.items():
            st = popt.state[p]
            assert int(st["step"]) == int(adam.count) == 3
            for got, want in ((st["exp_avg"], adam.mu[k]), (st["exp_avg_sq"], adam.nu[k])):
                want = np.asarray(want)  # float32 sums of terms that cancel: absolute, against the largest entry
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7 * np.abs(want).max())
            np.testing.assert_allclose(resumed[k].detach().numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("optimizer,weight_decay", [("adam", 1e-2), ("sgd", 1e-2)])
def test_three_steps_match_optax(level_params, batch, optimizer, weight_decay):
    """Three ``train_step``s on the plain path against the JAX ``train_step``
    with optax, the schedule fed per epoch: the loss of every step, and the
    update of every leaf after every step, as the relative L2 distance of
    the two packages' parameters over the distance moved from the start.
    Leaves whose gradient passes no ReLU mask: 1e-4 after the first step
    (measured 2.1e-5) and 5e-3 after the later ones (1.8e-3), whose
    gradients see the trunks' differences.  The trunk's updates carry its
    gradients' ReLU-flip differences (see the note at the top): under SGD as
    they are (below 5e-2, measured 2.6e-2); under Adam, whose first steps
    are ``lr * sign(g)``, an element whose small gradient changes sign moves
    by ``2 lr`` (measured: up to 3.9% of a leaf's elements after three
    steps), so there the share of elements off by more than 1e-5 stays below
    6%."""
    hp = _hp(optimizer, weight_decay)
    fields = dict(depth_weight=8.0, proj_weight=1.0, depth_smooth_weight=0.5)
    jcfg = jax_step.TrainConfig(render=_settings(jax_renderer, "xla"), imsize=PS, **fields)
    pcfg = port_step.TrainConfig(render=_settings(port_renderer, "xla"), **fields)
    opt = jax_optimizers.get_optimizer(hp)
    params = jax.tree_util.tree_map(jnp.asarray, level_params)
    jstate = jax_step.TrainState(params=params, opt_g=opt.init(params), d_params=None, sn_state=None, opt_d=None,
                                 vit_params=None, ref_feature=None, vgg_params=None, step=jnp.zeros((), jnp.int32))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    models = _models(level_params)
    named = _named_params(models)
    start = {k: p.detach().numpy().copy() for k, p in named.items()}
    pstate = port_step.TrainState(models=models, opt_g=port_optimizers.get_optimizer(hp, list(named.values())))
    pbatch = {k: _t(v) for k, v in batch.items()}
    for step in range(3):
        lr = jax_optimizers.lr_for_epoch(hp, step)
        key = jax.random.key(100 + step)
        jstate = jstate._replace(opt_g=jax_optimizers.set_lr(jstate.opt_g, lr))
        jstate, jout = jax_step.train_step(jstate, jbatch, key, jnp.asarray(float(step)), jcfg, opt, None)
        port_optimizers.set_lr(pstate.opt_g, port_optimizers.lr_for_epoch(hp, step))
        pstate, pout = port_step.train_step(pstate, pbatch, pcfg, float(step), _port_draws(jax.random.split(key, 6)[0]))
        np.testing.assert_allclose(pout["metrics"]["train/loss"].item(), float(jout["metrics"]["train/loss"]), rtol=1e-4)
        want = _flat_tree(jstate.params)
        for name, p in named.items():
            got = p.detach().numpy()
            moved = np.linalg.norm(want[name] - start[name])
            if _mask_free(name.split(".", 1)[1]):
                assert np.linalg.norm(got - want[name]) <= (1e-4 if step == 0 else 5e-3) * moved, (step, name)
            elif optimizer == "adam":
                assert np.mean(np.abs(got - want[name]) > 1e-5) < 6e-2, (step, name)
            else:
                assert np.linalg.norm(got - want[name]) < 5e-2 * moved, (step, name)
    assert pstate.step == 3 and int(jstate.step) == 3


def test_state_dict_round_trip_of_a_gradient_tree(level_params):
    """The carrier used above for gradients and moments is its own inverse."""
    tree = level_params["coarse"]
    back = jax_from_state_dict(state_dict_from_jax(tree))
    assert set(back) == set(tree)
    for k in tree:
        np.testing.assert_array_equal(back[k]["w"], tree[k]["w"])
        np.testing.assert_array_equal(back[k]["b"], tree[k]["b"])


# --------------------------------------------------------------------------
# what the step refuses
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fields", [dict(vit_weight=10.0), dict(dis_weight=1e-4), dict(patch_loss="l2_vgg"),
                                    dict(loss_type="l2_vgg"), dict(load_depth=False)],
                         ids=["vit", "gan", "patch_l2_vgg", "rays_l2_vgg", "no_depth"])
def test_step2_extras_raise(level_params, batch, fields):
    """The Step-2 extras raise without the module they read (the trainer
    builds them: ``vit``, ``discriminator``, ``vgg``; tests/test_torch_step2.py
    holds them to the JAX package); the VGG loss on ray bundles and a run
    without depth are refused, as in the reference and the JAX trainer."""
    cfg = port_step.TrainConfig(render=_settings(port_renderer, "xla"), **fields)
    with pytest.raises(NotImplementedError if "load_depth" in fields else ValueError):
        port_step.compute_losses(_models(level_params), {k: _t(v) for k, v in batch.items()}, cfg)


@pytest.mark.parametrize("name", ["radam", "ranger"])
def test_later_optimizers_raise(name):
    """radam and ranger are built (tests/test_torch_optimizers.py holds them
    to optax) and raise on an invalid learning rate; an unknown name raises."""
    model = torch.nn.Linear(2, 2)
    opt = port_optimizers.get_optimizer(argparse.Namespace(optimizer=name, lr=1e-3), model.parameters())
    assert isinstance(opt, port_optimizers.Ranger if name == "ranger" else port_optimizers.RAdam)
    with pytest.raises(ValueError):
        port_optimizers.get_optimizer(argparse.Namespace(optimizer=name, lr=-1e-3), model.parameters())
    with pytest.raises(ValueError):
        port_optimizers.get_optimizer(argparse.Namespace(optimizer="lion", lr=1e-3), model.parameters())


def test_l2_vgg_loss_raises(images):
    """The VGG loss takes images: on ray bundles it raises, as the
    reference's does (losses.py:129); tests/test_torch_gan_vit.py holds it on
    images to the JAX package."""
    from sinnerf_tpu_torch.models.vgg import VGG16Features

    a, b = images
    flat = {"rgb_coarse": _t(a).reshape(-1, 3), "rgb_fine": _t(a).reshape(-1, 3)}
    with pytest.raises(ValueError):
        port_photo.loss_dict["l2_vgg"](flat, _t(b).reshape(-1, 3), VGG16Features(torch.Generator().manual_seed(0)))
