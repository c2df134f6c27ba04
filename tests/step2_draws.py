"""Shared by the port's Step-2 tests: the random draws of the JAX package's
Step-2 modules, made with their own key splits and returned as the port's
draw tuples (DiffAugment, ``sinnerf_tpu/models/diffaug.py:80-103``; one
discriminator call, ``models/discriminator.py:268-272``; the Step-2 losses
of ``compute_losses``, ``train/step.py:133, 195-352``), and ViT weights in
the JAX package's layout drawn with numpy (jitting JAX's own initialiser
costs more than the tests that use it)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sinnerf_tpu_torch.models import diffaug as port_diffaug
from sinnerf_tpu_torch.models import discriminator as port_disc
from sinnerf_tpu_torch.train import step as port_step

POLICY = "color,translation,cutout"


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_diffaug_draws(key, shape, policy=POLICY):
    """The draws ``jax diff_augment(x, key, policy)`` makes (diffaug.py:80-103)."""
    n, _, h, w = shape
    k_skip, key = jax.random.split(key)
    d = {}
    for p in policy.split(","):
        if p == "color":
            for name in ("brightness", "saturation", "contrast"):
                key, sub = jax.random.split(key)
                d[name] = jax.random.uniform(sub, (n, 1, 1, 1), jnp.float32)
            continue
        key, sub = jax.random.split(key)
        kh, kw = jax.random.split(sub)
        if p == "translation":
            sh, sw = int(h * 0.125 + 0.5), int(w * 0.125 + 0.5)
            d["shift_h"] = jax.random.randint(kh, (n, 1, 1), -sh, sh + 1)
            d["shift_w"] = jax.random.randint(kw, (n, 1, 1), -sw, sw + 1)
        else:
            ch, cw = int(h * 0.5 + 0.5), int(w * 0.5 + 0.5)
            d["cutout_h"] = jax.random.randint(kh, (n, 1, 1), 0, h + (1 - ch % 2))
            d["cutout_w"] = jax.random.randint(kw, (n, 1, 1), 0, w + (1 - cw % 2))
    d["skip"] = jax.random.bernoulli(k_skip, 0.5)
    return port_diffaug.DiffAugDraws(**{k: _t(v) for k, v in d.items()})


def jax_dcall_draws(key, shape, policy=POLICY):
    """The draws of one ``discriminator_apply`` call with ``key``
    (discriminator.py:268-272)."""
    k_coin, k_aug = jax.random.split(key)
    return port_disc.DCallDraws(coin=_t(jax.random.bernoulli(k_coin, 0.5)),
                                aug=jax_diffaug_draws(k_aug, shape, policy))


def key_where(pred, seed=0):
    """The first key fold_in(key(seed), i) whose draws satisfy ``pred``."""
    for i in range(200):
        key = jax.random.fold_in(jax.random.key(seed), i)
        if pred(key):
            return key
    raise AssertionError("no key found")


def jax_step2_draws(key, b, patch_shape, policy="color,cutout", refresh_prob=0.05):
    """The Step-2 draws ``jax compute_losses(..., key, ...)`` makes: the ViT
    refresh coins from keys[1] and the discriminator calls from keys[2:6]
    (relavistic's outer augmentation from keys[5])."""
    keys = jax.random.split(key, 6)
    shape = (b, *patch_shape)
    k_coin, k_aug, k_d = jax.random.split(keys[5], 3)
    return port_step.Step2Draws(
        refresh=_t(jax.random.bernoulli(keys[1], refresh_prob, (b, 1)))[:, 0],
        d_fake_g=jax_dcall_draws(keys[2], shape, policy),
        real_g_coin=_t(jax.random.bernoulli(k_coin, 0.5)),
        real_g_aug=jax_diffaug_draws(k_aug, shape, policy),
        d_real_g=jax_dcall_draws(k_d, shape, policy),
        d_real=jax_dcall_draws(keys[3], shape, policy),
        d_fake=jax_dcall_draws(keys[4], shape, policy),
    )



def _uniform(rng, fan_in, shape):
    bound = 1.0 / np.sqrt(fan_in)
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def jax_vit_params(rng, blocks):
    """JAX ``init_vit_params``' layout with ``blocks`` blocks: the patch
    embedding, CLS token and positions normal x 0.02, linear layers uniform in
    +-1/sqrt(fan_in), norms near 1 and 0 (perturbed, so that a swapped gain
    and bias shows)."""
    d = 384

    def lin(a, b):
        return {"w": _uniform(rng, a, (a, b)), "b": _uniform(rng, a, (b,))}

    def norm():
        return {"g": (1.0 + 0.1 * rng.normal(size=d)).astype(np.float32),
                "b": (0.1 * rng.normal(size=d)).astype(np.float32)}

    return {
        "patch_embed": {"w": (0.02 * rng.normal(size=(d, 3, 16, 16))).astype(np.float32),
                        "b": (0.02 * rng.normal(size=d)).astype(np.float32)},
        "cls_token": (0.02 * rng.normal(size=(1, 1, d))).astype(np.float32),
        "pos_embed": (0.02 * rng.normal(size=(1, 197, d))).astype(np.float32),
        "blocks": [{"norm1": norm(), "qkv": lin(d, 3 * d), "proj": lin(d, d), "norm2": norm(),
                    "fc1": lin(d, 4 * d), "fc2": lin(4 * d, d)} for _ in range(blocks)],
    }
