"""Adversarial losses of the PatchGAN branch.

Counterpart of ``sinnerf_tpu/losses/gan.py`` (reference
``models/sinnerf.py:88-121, 241-256, 445-487``): pure functions of the
discriminator's logits; the discriminator itself is
``sinnerf_tpu_torch/models/discriminator.py``.  Flavors (``--dloss``):
``hinge`` (the default), ``vanilla``, ``relavistic`` [sic], ``wgan`` and
``wgan_gp``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

DLOSSES = ("hinge", "vanilla", "relavistic", "wgan", "wgan_gp")


def gan_ls_loss(pred: torch.Tensor, target_is_real: bool) -> torch.Tensor:
    """LSGAN MSE against a 1/0 target (GANLoss with use_lsgan=True,
    sinnerf.py:95-96)."""
    target = 1.0 if target_is_real else 0.0
    return torch.mean((pred - target) ** 2)


def gan_bce_loss(pred: torch.Tensor, target_is_real: bool) -> torch.Tensor:
    """BCE-with-logits against a 1/0 target, in the JAX package's stable form."""
    target = 1.0 if target_is_real else 0.0
    return torch.mean(torch.clamp(pred, min=0.0) - pred * target + torch.log1p(torch.exp(-torch.abs(pred))))


def _wgan_compute_loss(d_out: torch.Tensor, target: float) -> torch.Tensor:
    """(2 * target - 1) * mean(d_out) (sinnerf.py:241-256)."""
    return (2.0 * target - 1.0) * torch.mean(d_out)


def g_loss(pred_fake: torch.Tensor, dloss: str, pred_real: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Generator adversarial loss (sinnerf.py:445-461); ``relavistic`` also
    needs D's output on (augmented) real patches."""
    if dloss == "hinge":
        return -torch.mean(pred_fake)
    if dloss == "vanilla":
        return gan_ls_loss(pred_fake, True)
    if dloss == "relavistic":
        if pred_real is None:
            raise ValueError("relavistic g_loss needs pred_real")
        return (gan_ls_loss(pred_real - torch.mean(pred_fake), False)
                + gan_ls_loss(pred_fake - torch.mean(pred_real), True)) / 2.0
    if dloss in ("wgan", "wgan_gp"):
        return _wgan_compute_loss(pred_fake, 1.0)
    raise NotImplementedError(f"unknown dloss {dloss!r}")


def d_loss(pred_real: torch.Tensor, pred_fake: torch.Tensor, dloss: str) -> torch.Tensor:
    """Discriminator loss on real and (detached) fake logits
    (sinnerf.py:462-487)."""
    if dloss == "hinge":
        return (torch.mean(F.relu(1.0 - pred_real)) + torch.mean(F.relu(1.0 + pred_fake))) / 2.0
    if dloss == "relavistic":
        return (gan_ls_loss(pred_real - torch.mean(pred_fake), True)
                + gan_ls_loss(pred_fake - torch.mean(pred_real), False)) / 2.0
    if dloss == "vanilla":
        return (gan_ls_loss(pred_real, True) + gan_ls_loss(pred_fake, False)) / 2.0
    if dloss in ("wgan", "wgan_gp"):
        return _wgan_compute_loss(pred_fake, 0.0) + _wgan_compute_loss(pred_real, 1.0)
    raise NotImplementedError(f"unknown dloss {dloss!r}")
