"""Photometric reconstruction losses over render result dicts.

Counterpart of ``sinnerf_tpu/losses/photometric.py`` (reference
``losses.py:12-153``): each loss takes the renderer's ``{'rgb_coarse',
'rgb_fine', ...}`` dict and a target and returns a dict with at least
``'tot'`` and ``'l2'``.  ``l2_vgg`` takes the VGG16 trunk's features
(``sinnerf_tpu_torch/models/vgg.py``); the training step binds it to the
image-patch loss only.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from sinnerf_tpu_torch.models.vgg import vgg_preprocess
from sinnerf_tpu_torch.utils.metrics import dssim_loss

ResultDict = Dict[str, torch.Tensor]
LossDict = Dict[str, torch.Tensor]

SSIM_RATIO = 2.8333  # MonoDepth-derived SSIM/L2 mixing ratio (losses.py:109)
VGG_RATIO = 0.01  # losses.py:149


def mse_loss(inputs: ResultDict, targets: torch.Tensor) -> LossDict:
    """coarse+fine L2 (losses.py:12-22)."""
    loss = torch.mean((inputs["rgb_coarse"] - targets) ** 2)
    if "rgb_fine" in inputs:
        loss = loss + torch.mean((inputs["rgb_fine"] - targets) ** 2)
    return {"tot": loss, "l2": loss}


def l2_ssim_loss(inputs: ResultDict, targets: torch.Tensor) -> LossDict:
    """L2 + 2.8333 * window-11 DSSIM on the fine image (losses.py:94-109).
    Inputs must be (B, C, H, W) images for the SSIM term."""
    out = mse_loss(inputs, targets)
    if "rgb_fine" in inputs:
        out["ssim"] = dssim_loss(inputs["rgb_fine"], targets, window_size=11)
        out["tot"] = out["l2"] + out["ssim"] * SSIM_RATIO
    return out


def l2_vgg_loss(
    inputs: ResultDict,
    targets: torch.Tensor,
    vgg_features: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> LossDict:
    """L2 + 0.01 * the mean absolute difference of the VGG16 relu4_3
    features of the fine image and the target (losses.py:112-149; JAX
    ``l2_vgg_loss`` :51-76).  ``vgg_features`` maps (B, 3, 224, 224)
    normalised images to feature maps (a ``VGG16Features``); without it the
    loss is the L2 alone, as in the JAX package."""
    out = mse_loss(inputs, targets)
    if vgg_features is not None and "rgb_fine" in inputs:
        f_pred = vgg_features(vgg_preprocess(inputs["rgb_fine"]))
        f_gt = vgg_features(vgg_preprocess(targets))
        out["vgg"] = torch.mean(torch.abs(f_pred - f_gt))
        out["tot"] = out["l2"] + out["vgg"] * VGG_RATIO
    return out


MSE_LOSS = "mse"
L2_SSIM_LOSS = "l2_ssim"
L2_VGG_LOSS = "l2_vgg"

loss_dict: Dict[str, Callable[..., LossDict]] = {
    MSE_LOSS: mse_loss,
    L2_SSIM_LOSS: l2_ssim_loss,
    L2_VGG_LOSS: l2_vgg_loss,
}
