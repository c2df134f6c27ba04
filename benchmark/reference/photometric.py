"""Photometric reconstruction losses over render result dicts.

Counterpart of ``sinnerf_tpu/losses/photometric.py`` (reference
``losses.py:12-153``): each loss takes the renderer's ``{'rgb_coarse',
'rgb_fine', ...}`` dict and a target and returns a dict with at least
``'tot'`` and ``'l2'``.  Only ``mse``, the loss of every recipe the
benchmark runs, is kept in this copy.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

ResultDict = Dict[str, torch.Tensor]
LossDict = Dict[str, torch.Tensor]


def mse_loss(inputs: ResultDict, targets: torch.Tensor) -> LossDict:
    """coarse+fine L2 (losses.py:12-22)."""
    loss = torch.mean((inputs["rgb_coarse"] - targets) ** 2)
    if "rgb_fine" in inputs:
        loss = loss + torch.mean((inputs["rgb_fine"] - targets) ** 2)
    return {"tot": loss, "l2": loss}


MSE_LOSS = "mse"

loss_dict: Dict[str, Callable[..., LossDict]] = {
    MSE_LOSS: mse_loss,
}
