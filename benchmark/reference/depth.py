"""Depth supervision losses.

Counterpart of ``sinnerf_tpu/losses/depth.py``: the masked SmoothL1 of
``models/sinnerf.py:32-42`` and kornia's ``inverse_depth_smoothness_loss``
(``models/sinnerf.py:370-373``).  Masked means are weighted sums with an
empty-mask guard, as in the JAX package: an empty mask gives 0, not NaN.
"""

from __future__ import annotations

from typing import Optional

import torch


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise SmoothL1: ``0.5 x^2 / beta`` for ``|x| < beta``, else
    ``|x| - 0.5 beta``."""
    diff = torch.abs(pred - target)
    return torch.where(diff < beta, 0.5 * diff**2 / beta, diff - 0.5 * beta)


def _masked_mean(loss: torch.Tensor, m: torch.Tensor, dim=None) -> torch.Tensor:
    """Mean of ``loss`` where ``m`` is 1, 0 where the mask is empty."""
    if dim is None:
        cnt, tot = torch.sum(m), torch.sum(loss * m)
    else:
        cnt, tot = torch.sum(m, dim=dim), torch.sum(loss * m, dim=dim)
    return torch.where(cnt > 0, tot / torch.clamp(cnt, min=1.0), torch.zeros_like(tot))


def smooth_l1_masked(
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    use_mask: bool = True,
) -> torch.Tensor:
    """Mean SmoothL1 over masked elements (models/sinnerf.py:38-42).
    ``mask=None, use_mask=True`` defaults the mask to ``target > 0``."""
    if mask is None and use_mask:
        mask = target > 0
    loss = smooth_l1(pred, target)
    if mask is None:
        return torch.mean(loss)
    return _masked_mean(loss, mask.to(loss.dtype))


def smooth_l1_masked_per_item(
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    use_mask: bool = True,
) -> torch.Tensor:
    """Per-item masked SmoothL1 mean, then the mean over the batch axis: a
    batch of N items reproduces N reference ranks of batch size 1, each
    with the empty-mask skip of ``models/sinnerf.py:400``."""
    if mask is None and use_mask:
        mask = target > 0
    loss = smooth_l1(pred, target)
    b = loss.shape[0]
    loss = loss.reshape(b, -1)
    if mask is None:
        return torch.mean(loss)
    return torch.mean(_masked_mean(loss, mask.reshape(b, -1).to(loss.dtype), dim=1))


def inverse_depth_smoothness_loss(idepth: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """Edge-aware smoothness of a (B, 1, H, W) depth-like map weighted by the
    gradients of a (B, 3, H, W) image, as kornia has it:
    ``w_x = exp(-mean_c |dI/dx|)``, ``loss = mean|d(idepth)/dx w_x| + (y term)``."""
    didx = idepth[..., :, :-1] - idepth[..., :, 1:]
    didy = idepth[..., :-1, :] - idepth[..., 1:, :]
    imdx = image[..., :, :-1] - image[..., :, 1:]
    imdy = image[..., :-1, :] - image[..., 1:, :]
    wx = torch.exp(-torch.mean(torch.abs(imdx), dim=-3, keepdim=True))
    wy = torch.exp(-torch.mean(torch.abs(imdy), dim=-3, keepdim=True))
    return torch.mean(torch.abs(didx * wx)) + torch.mean(torch.abs(didy * wy))
