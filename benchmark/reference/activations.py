"""Activation functions of the NeRF heads.

Counterpart of ``sinnerf_tpu/core/activations.py`` (reference
``models/activations.py:8-35``).
"""

from __future__ import annotations

import torch


def widened_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """``0.5 * (1 + (1 + 2*eps) * tanh(0.5 * x))``: a sigmoid widened to
    ``[-eps, 1 + eps]`` so RGB outputs can reach exact 0 and 1."""
    scale = 1.0 + 2.0 * eps
    return 0.5 * (1.0 + scale * torch.tanh(0.5 * x))


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """Numerically stable ``softplus(x - 1)``:
    ``log1p(exp(-|x-1|)) + max(x-1, 0)``."""
    sx = x - 1.0
    return torch.log1p(torch.exp(-torch.abs(sx))) + torch.clamp_min(sx, 0.0)
