"""The port's Step-2 training step against the JAX package on the CPU: the
DINO-ViT semantic loss and the PatchGAN terms of ``compute_losses`` for every
``--dloss``, the ViT cache's refresh logic, and two ``train_step``s with
both optimizers.

A tiny NeRF (6 layers of 32, the skip at the fifth) on the plain path (``mlp_impl="xla"``), the
ViT at full width over its first 2 blocks, the discriminator at ``ndf = 8``
on the 16 branch (``imsize = -1``, LLFF's), 16x16 patches.  Weights are the
JAX package's random ones carried across by the ``*_from_jax`` functions;
every draw (the render's, the refresh coins, each discriminator call's coin
and DiffAugment) is made in JAX from the key the JAX function is given,
with its own splits, and fed to the port.

Tolerances.  The total and every metric: rtol 1e-4 (atol 1e-5), as the
Step-1 step's.  The discriminator's ``u`` after its calls, and the ViT
cache: rtol 1e-5 (atol 1e-6).  Gradients per leaf as the largest
difference over the leaf's largest entry, in the Step-1 step's two groups
(``tests/test_torch_train_step.py``): the discriminator's and the NeRF
leaves whose gradient passes no ReLU mask < 1e-4 (measured up to 1.6e-5 and
2.1e-5), the trunk < 3e-2 (measured up to 8.7e-3: a pre-activation within
rounding of zero takes either side of the mask, and over this batch's few
points one flip moves a 32-wide leaf further than the Step-1 test's 256-wide
ones).  Two ``train_step``s with
SGD (momentum 0.9; the update is linear in the gradients, so the step's
plumbing shows without Adam's lr * sign(g) first steps, which turn an
element whose gradient lies within rounding of zero by 2 lr): per leaf, the
largest difference over the largest distance moved, in the gradients'
bands after the first step; after the second, whose gradients see the
trunks' differences, the mask-free leaves and the discriminator within
5e-3, as the Step-1 step's ``test_three_steps_match_optax`` holds them.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sinnerf_tpu.render import renderer as jax_renderer
from sinnerf_tpu.train import optimizers as jax_optimizers
from sinnerf_tpu.train import step as jax_step
from sinnerf_tpu_torch.losses.gan import DLOSSES
from sinnerf_tpu_torch.models import discriminator as port_disc
from sinnerf_tpu_torch.models import vit as port_vit
from sinnerf_tpu_torch.models.nerf import NeRF, state_dict_from_jax
from sinnerf_tpu_torch.render import renderer as port_renderer
from sinnerf_tpu_torch.train import optimizers as port_optimizers
from sinnerf_tpu_torch.train import step as port_step
from step2_draws import jax_step2_draws, jax_vit_params

N_RAND, PS, S, K = 32, 16, 4, 4  # rays per bundle, patch side, coarse and importance samples
DEPTH, WIDTH, NDF, VIT_BLOCKS = 6, 32, 8, 2
FIELDS = dict(depth_weight=8.0, proj_weight=1.0, depth_smooth_weight=0.5, vit_weight=10.0, dis_weight=0.5)
JAX_FIELDS = dict(FIELDS, imsize=-1)  # the port's discriminator takes its branch from its own imsize


def _t(a):
    return torch.from_numpy(np.array(a))


def _settings(module):
    return module.RenderSettings(n_samples=S, n_importance=K, perturb=1.0, noise_std=1.0, white_back=True,
                                 mlp_impl="xla")


def _uniform(rng, fan_in, shape):
    bound = 1.0 / np.sqrt(fan_in)
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def _nerf_params(rng):
    """JAX ``init_nerf_params``' layout at DEPTH x WIDTH (the skip at the
    fifth layer), numpy draws."""
    shapes = {f"xyz_encoding_{i + 1}": (63 if i == 0 else WIDTH, WIDTH) for i in range(DEPTH)}
    shapes["xyz_encoding_5"] = (WIDTH + 63, WIDTH)
    shapes.update(xyz_encoding_final=(WIDTH, WIDTH), sigma=(WIDTH, 1), dir_encoding=(WIDTH + 27, WIDTH // 2),
                  rgb=(WIDTH // 2, 3))
    params = {k: {"w": _uniform(rng, a, (a, b)), "b": _uniform(rng, a, (b,))} for k, (a, b) in shapes.items()}
    params["sigma"]["b"] = params["sigma"]["b"] + np.float32(0.3)  # a partly opaque field
    return params


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(40)
    nerf = {"coarse": _nerf_params(rng), "fine": _nerf_params(rng)}
    spec = port_disc.conv_spec(-1, NDF)
    d_params = {"convs": [{"w": _uniform(rng, cin * 16, (cout, cin, 4, 4))} for cin, cout, _ in spec]}
    sn = {"convs": [{"u": rng.normal(size=(cout,)).astype(np.float32)} for _, cout, _ in spec]}
    return nerf, d_params, sn, jax_vit_params(rng, VIT_BLOCKS)


def _rays(rng, n):
    o = rng.normal(scale=0.3, size=(n, 3))
    d = rng.normal(scale=0.3, size=(n, 3)) + [0.0, 0.0, -1.0]
    return np.concatenate([o, d, np.full((n, 1), 2.0), np.full((n, 1), 6.0)], 1).astype(np.float32)


def make_batch(b, seed=41):
    """A batch with the sampler's schema, b items of 16x16 patches."""
    rng = np.random.default_rng(seed)

    def f(a):
        return np.asarray(a, dtype=np.float32)

    def pos(*shape):
        return rng.uniform(2.0, 6.0, size=shape)

    return {
        "rays": np.stack([_rays(rng, N_RAND) for _ in range(b)]),
        "rgbs": f(rng.uniform(size=(b, N_RAND, 3))),
        "depth": f(pos(b, N_RAND, 1)),
        "rays_proj": np.stack([_rays(rng, N_RAND) for _ in range(b)]),
        "depth_proj": f(pos(b, N_RAND, 1)),
        "real_patch": f(rng.uniform(size=(b, 3, PS, PS))),
        "rays_full": np.stack([_rays(rng, PS * PS) for _ in range(b)]),
        "warp_patch": f(rng.uniform(size=(b, 3, PS, PS)) * (rng.uniform(size=(b, 1, PS, PS)) > 0.3)),
        "warp_patch_depth": f(pos(b, PS * PS, 1) * (rng.uniform(size=(b, PS * PS, 1)) > 0.5)),
        "depth_ray": np.stack([_rays(rng, PS * PS) for _ in range(b)]),
        "depth_gt": f(pos(b, PS * PS, 1)),
        "depth_ray_rgb": f(rng.uniform(size=(b, PS * PS, 3))),
    }


def _render_draws(key, n):
    """The draws ``render_rays`` makes from the render key (renderer.py:234)."""
    k_perturb, k_noise_c, k_pdf, k_noise_f = jax.random.split(jax.random.split(key, 6)[0], 4)
    return port_step.RenderDraws(_t(jax.random.uniform(k_perturb, (n, S))), _t(jax.random.normal(k_noise_c, (n, S))),
                                 _t(jax.random.uniform(k_pdf, (n, K))), _t(jax.random.normal(k_noise_f, (n, S + K))))


def port_models(weights):
    nerf, d_params, sn, vit = weights
    models = {}
    for level, p in nerf.items():
        models[level] = NeRF(depth=DEPTH, width=WIDTH)
        models[level].load_state_dict(state_dict_from_jax(p))
    disc = port_disc.Discriminator(-1, NDF)
    disc.load_state_dict(port_disc.discriminator_state_from_jax(d_params, sn, -1, NDF))
    v = port_vit.ViT(depth=VIT_BLOCKS)
    v.load_state_dict(port_vit.vit_state_from_jax(vit))
    return models, disc, port_vit.frozen(v)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _moved_rel(got, want, start):
    """Largest difference over the largest distance moved from ``start``."""
    want = torch.as_tensor(np.asarray(want))
    return float((got - want).abs().max() / (want - torch.as_tensor(np.asarray(start))).abs().max())


def _mask_free(name):
    """Whether a NeRF parameter's gradient passes no ReLU mask of the trunk."""
    return name.split(".")[0] in ("xyz_encoding_final", "sigma", "dir_encoding", "rgb")


def _n_rays(b):
    return b * (2 * N_RAND + 2 * PS * PS)


# --------------------------------------------------------------------------
# compute_losses, every dloss
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def batch1():
    return make_batch(1)


LOSSES_KEY = 42


@pytest.fixture(scope="module")
def jax_losses(weights, batch1):
    """dloss -> ``jax.value_and_grad`` of the JAX ``compute_losses`` wrt the
    NeRF and the discriminator on the first step (the ViT cache invalid),
    every ``--dloss`` in one jitted program (one compile, not five)."""
    nerf, d_params, sn, vit = weights
    key = jax.random.key(LOSSES_KEY)
    jbatch = {k: jnp.asarray(v) for k, v in batch1.items()}

    def value_and_grad(dloss):
        jcfg = jax_step.TrainConfig(render=_settings(jax_renderer), dloss=dloss, **JAX_FIELDS)

        def loss(g, d):
            return jax_step.compute_losses(g, d, sn, vit, jnp.zeros((1, 384)), jbatch, key, jnp.asarray(0.0), jcfg,
                                           ref_feature_valid=jnp.zeros((1,), bool))

        return jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)

    return jax.jit(lambda g, d: {dloss: value_and_grad(dloss)(g, d) for dloss in DLOSSES})(nerf, d_params)


@pytest.mark.parametrize("dloss", DLOSSES)
def test_compute_losses_with_vit_and_gan_matches_jax(weights, batch1, jax_losses, dloss):
    """Every loss term, the NeRF's and the discriminator's gradients and the
    ``u`` chain through the calls, against ``jax.value_and_grad`` of the JAX
    ``compute_losses`` on the first step (the ViT cache invalid)."""
    nerf, d_params, sn, vit = weights
    key = jax.random.key(LOSSES_KEY)
    (want_total, aux), (want_g, want_d) = jax_losses[dloss]

    models, disc, v = port_models(weights)
    pcfg = port_step.TrainConfig(render=_settings(port_renderer), dloss=dloss, **FIELDS)
    draws = jax_step2_draws(key, 1, (3, PS, PS))
    total, paux = port_step.compute_losses(
        models, {k: _t(x) for k, x in batch1.items()}, pcfg, 0.0, _render_draws(key, _n_rays(1)),
        discriminator=disc, vit=v, step2_draws=draws)
    total.backward()

    np.testing.assert_allclose(total.item(), float(want_total), rtol=1e-4)
    metrics = {k: np.asarray(x) for k, x in aux["metrics"].items()}
    assert set(paux["metrics"]) == set(metrics)
    for tag in ("train/loss_vit", "train/loss_d", "train/loss_g_adv"):
        assert abs(metrics[tag]) > 1e-6, tag  # the terms are live
    for tag, x in metrics.items():
        np.testing.assert_allclose(paux["metrics"][tag].numpy(), x, rtol=1e-4, atol=1e-5, err_msg=tag)
    want_u = [s["u"] for s in aux["sn_state"]["convs"]]
    assert len(paux["d_u"]) == len(want_u) == 3
    for got, w in zip(paux["d_u"], want_u):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(paux["ref_feature"].numpy(), aux["ref_feature"], rtol=1e-5, atol=1e-6)
    assert paux["ref_feature_valid"].tolist() == np.asarray(aux["ref_feature_valid"]).tolist() == [True]
    for level, m in models.items():
        want_level = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, want_g[level]))
        for name, p in m.state_dict(keep_vars=True).items():
            w = want_level[name].numpy()
            band = 1e-4 if _mask_free(name) else 3e-2
            assert _rel(p.grad.numpy(), w) < band, (level, name, _rel(p.grad.numpy(), w))
    for conv, w in zip(disc.convs(), want_d["convs"]):
        assert _rel(conv.weight_orig.grad.numpy(), w["w"]) < 1e-4, _rel(conv.weight_orig.grad.numpy(), w["w"])
    # compute_losses leaves the buffers and the cache arguments alone
    for conv, s in zip(disc.convs(), sn["convs"]):
        np.testing.assert_array_equal(conv.weight_u.numpy(), s["u"])


# --------------------------------------------------------------------------
# the ViT cache's refresh
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vit_only(weights):
    """(models, vit, batch of 2, cfg) with the GAN off."""
    models, _, v = port_models(weights)
    cfg = port_step.TrainConfig(render=_settings(port_renderer), **dict(FIELDS, dis_weight=0.0))
    return models, v, {k: _t(x) for k, x in make_batch(2, seed=43).items()}, cfg


def _count_vit_calls(monkeypatch):
    calls = []
    real = port_step.vit_cls

    def counted(model, x):
        calls.append(x.shape[0])
        return real(model, x)

    monkeypatch.setattr(port_step, "vit_cls", counted)
    return calls


REFRESH_CASES = {
    # name: (valid flags before, refresh coins, ViT batch sizes called, items refreshed)
    "first_step": ([False, False], [False, False], [2, 4], [True, True]),
    "a_coin": ([True, True], [True, False], [2, 4], [True, False]),
    "an_invalid_item": ([True, False], [False, False], [2, 4], [False, True]),
    "none": ([True, True], [False, False], [4], [False, False]),
}


@pytest.mark.parametrize("case", sorted(REFRESH_CASES))
def test_vit_refresh_logic(vit_only, monkeypatch, case):
    """Per item: refresh on its coin or while its flag is false; the fresh
    feature is the real patch's CLS, detached; no item refreshed runs no
    ViT on the real patch (one batched call for the two rendered patches).
    The flags come back true for every refreshed item."""
    valid, coins, want_calls, refreshed = REFRESH_CASES[case]
    models, v, batch, cfg = vit_only
    cached = torch.randn(2, 384, generator=torch.Generator().manual_seed(44))
    calls = _count_vit_calls(monkeypatch)
    _, aux = port_step.compute_losses(
        models, batch, cfg, 0.0, generator=torch.Generator().manual_seed(45), vit=v, ref_feature=cached,
        ref_feature_valid=torch.tensor(valid), step2_draws=port_step.Step2Draws(refresh=torch.tensor(coins)))
    assert calls == want_calls
    with torch.no_grad():
        fresh = port_vit.vit_cls(v, batch["real_patch"])
    for i, r in enumerate(refreshed):
        torch.testing.assert_close(aux["ref_feature"][i], fresh[i] if r else cached[i], rtol=0, atol=0)
    assert aux["ref_feature_valid"].tolist() == [a or b for a, b in zip(valid, refreshed)]
    assert aux["ref_feature_valid"].device.type == "cpu" and not aux["ref_feature"].requires_grad


def test_vit_refresh_coin_matches_jax(weights, vit_only):
    """A step whose JAX coin refreshes item 0 and not item 1, both cached:
    the JAX package's cache, flags and ViT loss on the same draws."""
    nerf, _, sn, vit = weights
    models, v, batch, cfg = vit_only

    def coins(k):
        return np.asarray(jax.random.bernoulli(jax.random.split(k, 6)[1], 0.05, (2, 1)))[:, 0].tolist()

    key = next(k for k in (jax.random.fold_in(jax.random.key(46), i) for i in range(2000)) if coins(k) == [True, False])
    cached = np.random.default_rng(47).normal(size=(2, 384)).astype(np.float32)
    jcfg = jax_step.TrainConfig(render=_settings(jax_renderer), **dict(JAX_FIELDS, dis_weight=0.0))
    _, aux = jax.jit(lambda k: jax_step.compute_losses(
        nerf, None, None, vit, jnp.asarray(cached), {n: jnp.asarray(x.numpy()) for n, x in batch.items()}, k,
        jnp.asarray(0.0), jcfg, ref_feature_valid=jnp.ones((2,), bool)))(key)
    _, paux = port_step.compute_losses(
        models, batch, cfg, 0.0, _render_draws(key, _n_rays(2)), vit=v, ref_feature=_t(cached),
        ref_feature_valid=torch.ones(2, dtype=torch.bool), step2_draws=jax_step2_draws(key, 2, (3, PS, PS)))
    np.testing.assert_allclose(paux["ref_feature"].numpy(), aux["ref_feature"], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(paux["ref_feature"][1].numpy(), cached[1])
    assert paux["ref_feature_valid"].tolist() == [True, True]
    np.testing.assert_allclose(paux["metrics"]["train/loss_vit"].numpy(), aux["metrics"]["train/loss_vit"], rtol=1e-4)


def test_refresh_coins_come_from_the_host_generator(vit_only, monkeypatch):
    """``refresh_coins`` draws each item's coin on the host from the
    generator given at p = VIT_REFRESH_PROB; without drawn coins the step
    draws them so from torch's default host generator: the same seed
    refreshes the same items."""
    models, v, batch, cfg = vit_only
    coins = port_step.refresh_coins(4096, torch.Generator().manual_seed(49))
    assert coins.device.type == "cpu" and coins.dtype == torch.bool
    assert torch.equal(coins, torch.rand((4096,), generator=torch.Generator().manual_seed(49)) < 0.05)
    assert port_step.VIT_REFRESH_PROB == 0.05 and 120 < int(coins.sum()) < 290
    seed = next(i for i in range(1000) if port_step.refresh_coins(2, torch.Generator().manual_seed(i)).tolist()
                == [True, False])
    calls = _count_vit_calls(monkeypatch)
    torch.manual_seed(seed)
    _, aux = port_step.compute_losses(models, batch, cfg, 0.0, generator=torch.Generator().manual_seed(48), vit=v,
                                      ref_feature=torch.zeros(2, 384), ref_feature_valid=torch.ones(2, dtype=torch.bool))
    assert calls == [2, 4]
    assert aux["ref_feature"][0].abs().sum() > 0 and aux["ref_feature"][1].abs().sum() == 0


# --------------------------------------------------------------------------
# train_step
# --------------------------------------------------------------------------


def test_two_train_steps_match_jax(weights, batch1):
    """Two ``train_step``s (hinge, SGD for G and at 0.2x for D): both
    models' parameters, the discriminator's ``u`` and the ViT cache after
    each, against the JAX ``train_step`` with optax."""
    nerf, d_params, sn, vit = weights
    hp = argparse.Namespace(optimizer="sgd", lr=1e-2, momentum=0.9, weight_decay=0.0)
    opt_g, opt_d = jax_optimizers.get_optimizer(hp), jax_optimizers.get_optimizer(hp, rate=0.2)
    jcfg = jax_step.TrainConfig(render=_settings(jax_renderer), **JAX_FIELDS)
    jstate = jax_step.TrainState(
        params=nerf, opt_g=opt_g.init(nerf), d_params=d_params, sn_state=sn, opt_d=opt_d.init(d_params),
        vit_params=vit, ref_feature=jnp.zeros((1, 384)), vgg_params=None, step=jnp.zeros((), jnp.int32),
        ref_feature_valid=jnp.zeros((1,), bool))
    jbatch = {k: jnp.asarray(v) for k, v in batch1.items()}

    models, disc, v = port_models(weights)
    g_params = [p for m in models.values() for p in m.parameters()]
    state = port_step.TrainState(
        models=models, opt_g=port_optimizers.get_optimizer(hp, g_params), discriminator=disc,
        opt_d=port_optimizers.get_optimizer(hp, disc.parameters(), rate=0.2), vit=v)
    pbatch = {k: _t(x) for k, x in batch1.items()}
    pcfg = port_step.TrainConfig(render=_settings(port_renderer), **FIELDS)
    for step in range(2):
        key = jax.random.key(50 + step)
        jstate, jout = jax_step.train_step(jstate, jbatch, key, jnp.asarray(0.0), jcfg, opt_g, opt_d)
        state, out = port_step.train_step(state, pbatch, pcfg, 0.0, _render_draws(key, _n_rays(1)),
                                          step2_draws=jax_step2_draws(key, 1, (3, PS, PS)))
        np.testing.assert_allclose(out["metrics"]["train/loss"].item(), float(jout["metrics"]["train/loss"]),
                                   rtol=1e-4)
        tight = 1e-4 if step == 0 else 5e-3
        for lvl, m in models.items():
            want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params[lvl]))
            start = state_dict_from_jax(nerf[lvl])
            for name, p in m.state_dict(keep_vars=True).items():
                err = _moved_rel(p.detach(), want[name], start[name])
                assert err < (tight if _mask_free(name) else 3e-2), (step, lvl, name, err)
        for c, w, w0 in zip(disc.convs(), jstate.d_params["convs"], d_params["convs"]):
            assert _moved_rel(c.weight_orig.detach(), _t(w["w"]), _t(w0["w"])) < tight, step
        for c, s in zip(disc.convs(), jstate.sn_state["convs"]):
            np.testing.assert_allclose(c.weight_u.numpy(), s["u"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(state.ref_feature.numpy(), jstate.ref_feature, rtol=1e-5, atol=1e-6)
        assert state.ref_feature_valid.tolist() == [True] and state.step == step + 1
