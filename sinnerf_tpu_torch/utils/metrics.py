"""Image quality metrics: MSE, PSNR, SSIM.

Counterpart of ``sinnerf_tpu/utils/metrics.py`` (reference ``metrics.py:5-24``
and the kornia ``ssim_loss`` of ``losses.py:105``): a separable gaussian
window (sigma 1.5) with reflect padding, C1 = 0.01^2, C2 = 0.03^2 on a
[0, 1] range.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def mse(image_pred: torch.Tensor, image_gt: torch.Tensor, valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    value = (image_pred - image_gt) ** 2
    if valid_mask is not None:
        mask = valid_mask.to(value.dtype)
        return torch.sum(value * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(value)


def psnr(image_pred: torch.Tensor, image_gt: torch.Tensor, valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``-10 * log10(mse)`` (metrics.py:14-15)."""
    return -10.0 * torch.log10(mse(image_pred, image_gt, valid_mask))


def _gaussian_kernel(window_size: int, sigma: float, like: torch.Tensor) -> torch.Tensor:
    x = torch.arange(window_size, dtype=torch.float32, device=like.device) - window_size // 2
    g = torch.exp(-(x**2) / (2.0 * sigma**2))
    return g / torch.sum(g)


def _filter2d_same(img: torch.Tensor, kernel1d: torch.Tensor) -> torch.Tensor:
    """Separable per-channel gaussian filter of (B, C, H, W) with reflect
    padding: two 1-D convolutions."""
    pad = kernel1d.shape[0] // 2
    b, c, h, w = img.shape
    x = F.pad(img, (pad, pad, pad, pad), mode="reflect").reshape(b * c, 1, h + 2 * pad, w + 2 * pad)
    x = F.conv2d(x, kernel1d.reshape(1, 1, -1, 1))
    x = F.conv2d(x, kernel1d.reshape(1, 1, 1, -1))
    return x.reshape(b, c, h, w)


def ssim_map(
    img1: torch.Tensor,
    img2: torch.Tensor,
    window_size: int = 11,
    sigma: float = 1.5,
    c1: float = 0.01**2,
    c2: float = 0.03**2,
) -> torch.Tensor:
    """Per-pixel SSIM map for (B, C, H, W) images in [0, 1]."""
    k = _gaussian_kernel(window_size, sigma, img1)
    mu1 = _filter2d_same(img1, k)
    mu2 = _filter2d_same(img2, k)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter2d_same(img1 * img1, k) - mu1_sq
    sigma2_sq = _filter2d_same(img2 * img2, k) - mu2_sq
    sigma12 = _filter2d_same(img1 * img2, k) - mu12
    return ((2 * mu12 + c1) * (2 * sigma12 + c2)) / ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))


def ssim(image_pred: torch.Tensor, image_gt: torch.Tensor, window_size: int = 3) -> torch.Tensor:
    """Mean SSIM in [-1, 1] (``metrics.py:18-24``: ``1 - 2 * dssim``)."""
    return torch.mean(ssim_map(image_pred, image_gt, window_size))


def dssim_loss(image_pred: torch.Tensor, image_gt: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """kornia ``ssim_loss``: mean of ``(1 - ssim_map) / 2`` (losses.py:105)."""
    return torch.mean((1.0 - ssim_map(image_pred, image_gt, window_size)) / 2.0)
