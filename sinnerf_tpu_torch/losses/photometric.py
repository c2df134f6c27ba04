"""Photometric reconstruction losses over render result dicts.

Counterpart of ``sinnerf_tpu/losses/photometric.py`` (reference
``losses.py:12-153``): each loss takes the renderer's ``{'rgb_coarse',
'rgb_fine', ...}`` dict and a target and returns a dict with at least
``'tot'`` and ``'l2'``.  ``l2_vgg`` needs the VGG16 features, which come with
the Step-2 extras in a later slice of the port; until then it raises.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from sinnerf_tpu_torch.utils.metrics import dssim_loss

ResultDict = Dict[str, torch.Tensor]
LossDict = Dict[str, torch.Tensor]

SSIM_RATIO = 2.8333  # MonoDepth-derived SSIM/L2 mixing ratio (losses.py:109)


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


def l2_vgg_loss(inputs: ResultDict, targets: torch.Tensor) -> LossDict:
    raise NotImplementedError(
        "l2_vgg needs the VGG16 feature extractor, which is ported with the Step-2 extras "
        "(ViT, PatchGAN, VGG) in a later slice; use 'mse' or 'l2_ssim'"
    )


MSE_LOSS = "mse"
L2_SSIM_LOSS = "l2_ssim"
L2_VGG_LOSS = "l2_vgg"

loss_dict: Dict[str, Callable[..., LossDict]] = {
    MSE_LOSS: mse_loss,
    L2_SSIM_LOSS: l2_ssim_loss,
    L2_VGG_LOSS: l2_vgg_loss,
}
