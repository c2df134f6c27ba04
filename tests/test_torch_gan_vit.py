"""The port's Step-2 modules against the JAX package on the CPU: the GAN
losses, DiffAugment, the PatchGAN discriminator with its spectral norm, the
DINO ViT-S/16 and the VGG16 trunk of the ``l2_vgg`` loss.

Weights are the JAX package's own random ones, carried across by the port's
``*_from_jax`` functions.  Random draws are made in JAX with the JAX
modules' own key splits (``models/diffaug.py:80-103``,
``models/discriminator.py:268-272``) and fed to the port as tensors.

Tolerances.  GAN losses: rtol 1e-6.  DiffAugment: translation, cutout and
the skip bit for bit (integer shifts and boxes, a gather and a mask), the
colour ops rtol 1e-6.  The nearest resize: bit for bit.  Discriminator
(float32 convolutions summed in other orders): logits and the new ``u``
rtol 1e-5, atol 2e-6 (|logits| up to ~1; measured 1.1e-6); gradients as the largest difference over the
largest entry, < 1e-5.  ViT over two blocks at full width: tokens atol 2e-5
(|tokens| ~ 3), the input gradient < 1e-5 of its largest entry.  VGG
relu4_3 maps < 1e-5 of their largest entry; ``l2_vgg_loss`` rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sinnerf_tpu.losses import gan as jax_gan
from sinnerf_tpu.losses import photometric as jax_photo
from sinnerf_tpu.models import diffaug as jax_diffaug
from sinnerf_tpu.models import discriminator as jax_disc
from sinnerf_tpu.models import vgg as jax_vgg
from sinnerf_tpu.models import vit as jax_vit
from sinnerf_tpu_torch.losses import gan as port_gan
from sinnerf_tpu_torch.losses import photometric as port_photo
from sinnerf_tpu_torch.models import diffaug as port_diffaug
from sinnerf_tpu_torch.models import discriminator as port_disc
from sinnerf_tpu_torch.models import vgg as port_vgg
from sinnerf_tpu_torch.models import vit as port_vit
from step2_draws import jax_dcall_draws, jax_diffaug_draws, jax_vit_params, key_where

POLICY = "color,translation,cutout"  # all three, in the order diff_augment applies them


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    """Largest difference over the largest entry."""
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


# --------------------------------------------------------------------------
# GAN losses
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def logits():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(2, 1, 12, 19)).astype(np.float32), rng.normal(size=(2, 1, 12, 19)).astype(np.float32))


@pytest.mark.parametrize("dloss", port_gan.DLOSSES)
def test_gan_losses_match_jax(logits, dloss):
    fake, real = logits
    want_g = jax_gan.g_loss(jnp.asarray(fake), dloss, pred_real=jnp.asarray(real))
    want_d = jax_gan.d_loss(jnp.asarray(real), jnp.asarray(fake), dloss)
    np.testing.assert_allclose(port_gan.g_loss(_t(fake), dloss, pred_real=_t(real)).numpy(), want_g, rtol=1e-6)
    np.testing.assert_allclose(port_gan.d_loss(_t(real), _t(fake), dloss).numpy(), want_d, rtol=1e-6)


def test_gan_target_losses_match_jax(logits):
    fake, _ = logits
    for real in (True, False):
        for name in ("gan_ls_loss", "gan_bce_loss"):
            want = getattr(jax_gan, name)(jnp.asarray(fake * 30.0), real)
            got = getattr(port_gan, name)(_t(fake * 30.0), real)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, err_msg=name)
    with pytest.raises(ValueError):
        port_gan.g_loss(_t(fake), "relavistic")
    with pytest.raises(NotImplementedError):
        port_gan.d_loss(_t(fake), _t(fake), "lsgan")


# --------------------------------------------------------------------------
# DiffAugment
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def patches():
    return np.random.default_rng(1).uniform(size=(3, 3, 21, 26)).astype(np.float32)


OPS = {
    "brightness": ("rand_brightness", lambda d: (d.brightness,), "color", 0),
    "saturation": ("rand_saturation", lambda d: (d.saturation,), "color", 1),
    "contrast": ("rand_contrast", lambda d: (d.contrast,), "color", 2),
    "translation": ("rand_translation", lambda d: (d.shift_h, d.shift_w), "translation", 0),
    "cutout": ("rand_cutout", lambda d: (d.cutout_h, d.cutout_w), "cutout", 0),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_diffaug_ops_match_jax(patches, op):
    """Each op on the JAX draw its key gives: the integer shifts and boxes
    bit for bit."""
    name, args, policy, index = OPS[op]
    key = jax.random.key(3)
    # the sub-key diff_augment hands the op: split off the skip key, then one per op
    _, k = jax.random.split(key)
    for _ in range(index + 1):
        k, sub = jax.random.split(k)
    want = np.asarray(getattr(jax_diffaug, name)(jnp.asarray(patches), sub))
    draws = jax_diffaug_draws(key, patches.shape, policy)
    got = getattr(port_diffaug, name)(_t(patches), *args(draws)).numpy()
    if policy == "color":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(got, want)
        assert (got == 0).any() and (got != 0).any()


@pytest.mark.parametrize("skip", [False, True])
def test_diff_augment_with_its_skip_coin_matches_jax(patches, skip):
    key = key_where(lambda k: bool(jax.random.bernoulli(jax.random.split(k)[0], 0.5)) == skip)
    want = np.asarray(jax_diffaug.diff_augment(jnp.asarray(patches), key, POLICY))
    got = port_diffaug.diff_augment(_t(patches), POLICY, jax_diffaug_draws(key, patches.shape)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.array_equal(got, patches) == skip


def test_diff_augment_draws_from_the_generator(patches):
    x = _t(patches)
    applied = port_diffaug.DiffAugDraws(skip=torch.tensor(False))
    a = port_diffaug.diff_augment(x, POLICY, applied, generator=torch.Generator().manual_seed(4))
    b = port_diffaug.diff_augment(x, POLICY, applied, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, x)
    d = port_diffaug.fill_draws(x, POLICY, generator=torch.Generator().manual_seed(5))
    assert all(v is not None for v in d)
    assert d.shift_h.abs().max() <= 3 and d.cutout_w.max() < 26 + 1
    with pytest.raises(ValueError):
        port_diffaug.diff_augment(x, "color,blur")


# --------------------------------------------------------------------------
# discriminator
# --------------------------------------------------------------------------

NDF = 8
# (imsize branch, input H, W, conditional); -1 takes the 16 branch, as on LLFF's 63x84 patches
D_CASES = {
    "128": (128, 128, 128, False),
    "64": (64, 64, 64, False),
    "32": (32, 32, 32, False),
    "16": (16, 16, 16, False),
    "llff": (-1, 63, 84, False),
    "conditional": (32, 32, 32, True),
}


def _jax_d(imsize, conditional, seed=7):
    """(params, sn_state) in JAX ``init_discriminator``'s layout and
    distributions (discriminator.py:59-97), drawn with numpy: jitting the JAX
    initialiser for every branch costs more than the tests that use it."""
    rng = np.random.default_rng(seed)

    def layer(cout, cin, k):
        bound = 1.0 / np.sqrt(cin * k * k)
        return ({"w": rng.uniform(-bound, bound, (cout, cin, k, k)).astype(np.float32)},
                {"u": rng.normal(size=(cout,)).astype(np.float32)})

    convs = [layer(cout, cin, 4) for cin, cout, _ in port_disc.conv_spec(imsize, NDF, final_dim=NDF if conditional
                                                                          else 1)]
    params, sn = {"convs": [c[0] for c in convs]}, {"convs": [c[1] for c in convs]}
    if conditional:  # the 1x1 head over [features, Embedding(1, 4)'s 9 channels]
        head = [layer(cout, cin, 1) for cin, cout in [(NDF + 9, NDF), (NDF, NDF), (NDF, 1)]]
        params["head"], sn["head"] = [h[0] for h in head], [h[1] for h in head]
    want = jax.eval_shape(lambda k: jax_disc.init_discriminator(k, imsize, NDF, conditional), jax.random.key(0))
    assert jax.tree_util.tree_map(np.shape, (params, sn)) == jax.tree_util.tree_map(lambda a: a.shape, want)
    return params, sn


def _port_d(params, sn, imsize, conditional):
    model = port_disc.Discriminator(imsize, NDF, conditional)
    model.load_state_dict(port_disc.discriminator_state_from_jax(params, sn, imsize, NDF))
    return model


@pytest.mark.parametrize("case", sorted(D_CASES))
def test_discriminator_matches_jax(case):
    """Logits, the new ``u`` of every convolution, and the gradients with
    respect to every weight (the sigma term included) and to the input, on
    the JAX draws (the coin and DiffAugment both on)."""
    imsize, h, w, conditional = D_CASES[case]
    params, sn = _jax_d(imsize, conditional)
    rng = np.random.default_rng(8)
    x = rng.uniform(size=(2, 3, h, w)).astype(np.float32)
    y = rng.uniform(size=(2,)).astype(np.float32) if conditional else None

    def applies(k):
        k_coin, k_aug = jax.random.split(k)
        return bool(jax.random.bernoulli(k_coin, 0.5)) and not bool(jax.random.bernoulli(jax.random.split(k_aug)[0], 0.5))

    key = key_where(applies)
    out_shape = jax.eval_shape(lambda p, x: jax_disc.discriminator_apply(
        p, sn, x, key=key, y=None if y is None else jnp.asarray(y), policy=POLICY, ndf=NDF, imsize=imsize)[0],
        params, jnp.asarray(x)).shape
    cot = rng.normal(size=out_shape).astype(np.float32)

    def loss(p, xx):
        out, new_sn = jax_disc.discriminator_apply(p, sn, xx, key=key, y=None if y is None else jnp.asarray(y),
                                                   policy=POLICY, ndf=NDF, imsize=imsize)
        return jnp.sum(out * cot), (out, new_sn)

    (_, (want, want_sn)), (g_params, g_x) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    model = _port_d(params, sn, imsize, conditional)
    xt = _t(x).requires_grad_(True)
    got, new_u = model(xt, draws=jax_dcall_draws(key, x.shape), policy=POLICY, y=None if y is None else _t(y))
    (got * _t(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=2e-6)
    want_u = [s["u"] for s in want_sn["convs"] + want_sn.get("head", [])]
    want_g = [p["w"] for p in g_params["convs"] + g_params.get("head", [])]
    assert len(new_u) == len(want_u) == len(model.convs())
    for i, (u, wu, conv, wg) in enumerate(zip(new_u, want_u, model.convs(), want_g)):
        np.testing.assert_allclose(u.numpy(), wu, rtol=1e-5, atol=1e-6, err_msg=f"u {i}")
        assert _rel(conv.weight_orig.grad.numpy(), wg) < 1e-5, i
    assert _rel(xt.grad.numpy(), g_x) < 1e-5
    # the call leaves the buffers alone
    for conv, s in zip(model.convs(), sn["convs"] + sn.get("head", [])):
        np.testing.assert_array_equal(conv.weight_u.numpy(), np.asarray(s["u"]))


def test_discriminator_frozen_and_plain_calls():
    """``frozen``: the same logits and ``u``, no weight gradient, the same
    input gradient.  Without a policy D runs on the input as it is, as the
    JAX package's call without a key."""
    imsize = 32
    params, sn = _jax_d(imsize, False)
    model = _port_d(params, sn, imsize, False)
    x = torch.rand(2, 3, 32, 32, generator=torch.Generator().manual_seed(9))
    outs = []
    for frozen in (False, True):
        xt = x.clone().requires_grad_(True)
        out, u = model(xt, frozen=frozen, policy="")
        out.sum().backward()
        outs.append((out.detach(), u, xt.grad))
    assert all(c.weight_orig.grad is not None for c in model.convs())
    model.zero_grad(set_to_none=True)
    xt = x.clone().requires_grad_(True)
    model(xt, frozen=True, policy="")[0].sum().backward()
    assert all(c.weight_orig.grad is None for c in model.convs())
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    torch.testing.assert_close(outs[0][2], outs[1][2], rtol=0, atol=0)
    for a, b in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    want, want_sn = jax_disc.discriminator_apply(params, sn, jnp.asarray(x.numpy()), key=None, ndf=NDF, imsize=imsize)
    np.testing.assert_allclose(outs[0][0].numpy(), want, rtol=1e-5, atol=2e-6)
    for a, s in zip(outs[0][1], want_sn["convs"]):
        np.testing.assert_allclose(a.numpy(), s["u"], rtol=1e-5, atol=1e-6)


def test_spectral_norm_matches_jax():
    rng = np.random.default_rng(10)
    w = rng.normal(size=(16, 8, 4, 4)).astype(np.float32)
    u = rng.normal(size=(16,)).astype(np.float32)
    want_w, want_u = jax_disc._spectral_norm(jnp.asarray(w), jnp.asarray(u), True)
    got_w, got_u = port_disc.spectral_normalize(_t(w), _t(u))
    np.testing.assert_allclose(got_w.numpy(), want_w, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got_u.numpy(), want_u, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("imsize,conditional", [(-1, False), (64, False), (128, False), (32, True)])
def test_discriminator_torch_state_round_trip(imsize, conditional):
    """The reference's ``D.main.<slot>.weight_orig / weight_u / weight_v``
    layout: the port's export reads back in the JAX importer as the JAX
    params, the JAX export loads into the port, and ``weight_v`` agrees."""
    params, sn = _jax_d(imsize, conditional, seed=11)
    model = _port_d(params, sn, imsize, conditional)
    sd = port_disc.export_torch_discriminator_state(model, prefix="D.")
    want_sd = jax_disc.export_torch_discriminator_state(params, sn, imsize=imsize, ndf=NDF, prefix="D.")
    assert set(sd) == set(want_sd)
    for k, v in want_sd.items():
        np.testing.assert_allclose(sd[k].numpy(), v, rtol=1e-6, atol=1e-7, err_msg=k)
    back, back_sn = jax_disc.import_torch_discriminator_state({k: v.numpy() for k, v in sd.items()}, prefix="D.")
    for a, b in zip(jax.tree_util.tree_leaves((back, back_sn)), jax.tree_util.tree_leaves((params, sn))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    fresh = port_disc.Discriminator(imsize, NDF, conditional)
    port_disc.import_torch_discriminator_state(fresh, {k: _t(v) for k, v in want_sd.items()}, "D.")
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    sd["D.main.0.weight_u"].add_(1.0)  # an exported tensor is a copy, not the live buffer
    assert not torch.equal(sd["D.main.0.weight_u"], model.main["0"].weight_u)
    with pytest.raises(KeyError):
        port_disc.import_torch_discriminator_state(fresh, {"nerf_coarse.sigma.weight": torch.zeros(1)}, "D.")


def test_discriminator_sizes():
    assert port_disc.main_slots(64) == jax_disc._torch_main_slots(64)
    assert port_disc.main_slots(-1) == jax_disc._torch_main_slots(-1)
    assert port_disc.output_side(-1, 63) == 12 and port_disc.output_side(-1, 16) == 1
    assert port_disc.output_side(-1, 15) < 1 and port_disc.output_side(64, 64) == 1


# --------------------------------------------------------------------------
# ViT
# --------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(63, 84), (64, 64), (56, 70)])
def test_nearest_resize_is_bit_equal(hw):
    x = np.random.default_rng(12).uniform(size=(2, 3, *hw)).astype(np.float32)
    want = np.asarray(jax_vit.torch_nearest_resize(jnp.asarray(x), 224))
    got = port_vit.torch_nearest_resize(_t(x), 224)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, F.interpolate(_t(x), size=(224, 224), mode="nearest"))


@pytest.fixture(scope="module")
def vit_params():
    return jax_vit_params(np.random.default_rng(13), jax_vit.DEPTH)


def test_vit_tokens_match_jax_over_two_blocks(vit_params):
    """Full width, the first two blocks: every block's tokens and the
    gradient with respect to the raw image (through the resize and the
    normalisation)."""
    params = dict(vit_params, blocks=vit_params["blocks"][:2])
    rng = np.random.default_rng(14)
    x = rng.uniform(size=(2, 3, 63, 84)).astype(np.float32)
    cot = rng.normal(size=(2, 2, 197, 384)).astype(np.float32)

    def loss(xx):
        tokens = jax_vit.vit_tokens(params, jax_vit.vit_preprocess(xx))
        return jnp.sum(tokens * cot), tokens

    (_, want), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(x))
    model = port_vit.ViT(depth=2)
    model.load_state_dict(port_vit.vit_state_from_jax(params))
    xt = _t(x).requires_grad_(True)
    got = port_vit.vit_tokens(model, port_vit.vit_preprocess(xt))
    (got * _t(cot)).sum().backward()
    assert got.shape == (2, 2, 197, 384)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=2e-5)
    assert _rel(xt.grad.numpy(), want_g) < 1e-5
    cls = port_vit.vit_cls(model, _t(x))
    torch.testing.assert_close(cls, got[-1, :, 0].detach(), rtol=0, atol=0)


def test_vit_loads_the_dino_layout(vit_params, tmp_path):
    """``vit_state_from_jax`` writes DINO's key layout: the full model loads
    it with ``load_state_dict``, ``load_vit`` reads it from a ``.pth`` that
    also holds a head, and the JAX importer reads it back as its params."""
    sd = port_vit.vit_state_from_jax(vit_params)
    model = port_vit.ViT()
    model.load_state_dict(sd)  # strict
    assert "blocks.11.attn.qkv.weight" in sd and sd["blocks.0.mlp.fc1.weight"].shape == (1536, 384)
    path = tmp_path / "dino.pth"
    torch.save(dict(sd, **{"head.weight": torch.zeros(1)}), path)
    loaded = port_vit.load_vit(str(path))
    for k, v in sd.items():
        assert torch.equal(loaded.state_dict()[k], v), k
    assert not any(p.requires_grad for p in loaded.parameters()) and not loaded.training
    back = jax_vit.import_torch_vit_state(sd)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(vit_params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    torch.save({k: v for k, v in sd.items() if not k.startswith("blocks.3.")}, path)
    with pytest.raises(KeyError):
        port_vit.load_vit(str(path))


# --------------------------------------------------------------------------
# VGG
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vgg_pair():
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jax_vgg.init_vgg_params)(jax.random.key(15)))
    model = port_vgg.VGG16Features()
    model.load_state_dict(port_vgg.vgg_state_from_jax(params))
    return params, port_vit.frozen(model)


def test_vgg_features_match_jax(vgg_pair):
    params, model = vgg_pair
    x = np.random.default_rng(16).uniform(size=(1, 3, 40, 50)).astype(np.float32)
    want = jax.jit(lambda xx: jax_vgg.vgg_features(params, jax_vgg.vgg_preprocess(xx)))(jnp.asarray(x))
    with torch.no_grad():
        got = model(port_vgg.vgg_preprocess(_t(x)))
    assert got.shape == (1, 512, 28, 28)
    assert _rel(got.numpy(), want) < 1e-5


def test_l2_vgg_loss_matches_jax(vgg_pair):
    params, model = vgg_pair
    rng = np.random.default_rng(17)
    inputs = {k: rng.uniform(size=(1, 3, 16, 16)).astype(np.float32) for k in ("rgb_coarse", "rgb_fine")}
    target = rng.uniform(size=(1, 3, 16, 16)).astype(np.float32)
    want = jax.jit(lambda i, t: jax_photo.l2_vgg_loss(i, t, jax_vgg.make_vgg_features(params)))(
        {k: jnp.asarray(v) for k, v in inputs.items()}, jnp.asarray(target))
    with torch.no_grad():
        got = port_photo.l2_vgg_loss({k: _t(v) for k, v in inputs.items()}, _t(target), model)
    assert set(got) == set(want) == {"tot", "l2", "vgg"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5, err_msg=k)
    plain = port_photo.l2_vgg_loss({k: _t(v) for k, v in inputs.items()}, _t(target))
    assert set(plain) == {"tot", "l2"} and torch.equal(plain["tot"], got["l2"])


def test_vgg_loads_the_torchvision_layout(vgg_pair, tmp_path):
    params, _ = vgg_pair
    own = port_vgg.vgg_state_from_jax(params)
    full = dict(own, **{"classifier.0.weight": torch.zeros(2, 2)})
    sub = {k[len("features."):]: v for k, v in own.items()}
    for sd in (full, sub):
        back = jax_vgg.import_torch_vgg_state(sd)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
            np.testing.assert_array_equal(np.asarray(a), b)
        path = tmp_path / "vgg.pth"
        torch.save(sd, path)
        model = port_vgg.load_vgg(str(path))
        for k, v in own.items():
            assert torch.equal(model.state_dict()[k], v), k
    with pytest.raises(KeyError):
        port_vgg.import_torch_vgg_state({"features.0.weight": torch.zeros(1)})
