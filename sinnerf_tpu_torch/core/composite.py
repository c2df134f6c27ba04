"""Alpha compositing (volume-rendering quadrature).

Counterpart of ``sinnerf_tpu/core/composite.py`` (reference
``models/rendering.py:214-248``): the 1e10 cap on the last interval, deltas
scaled by the unnormalized ``||d||``, optional sigma noise, the
exclusive-cumprod transmittance with its ``+1e-10`` guard, and the white
background.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class CompositeOut(NamedTuple):
    rgb: torch.Tensor      # (N, 3)
    depth: torch.Tensor    # (N,)
    weights: torch.Tensor  # (N, S)


def ray_norm(rays_d: torch.Tensor) -> torch.Tensor:
    """``||d||`` as (N, 1), summed in channel order like the kernel does."""
    sq = rays_d * rays_d
    return torch.sqrt(sq[:, 0:1] + sq[:, 1:2] + sq[:, 2:3])


def compute_weights(
    sigmas: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``w_i = alpha_i * prod_{j<i} (1 - alpha_j + 1e-10)``.

    sigmas/z_vals (N, S); rays_d (N, 3) unnormalized.  ``noise`` (N, S), when
    given, is added to sigma before the ReLU (the caller scales it by
    ``noise_std``).
    """
    deltas = z_vals[..., 1:] - z_vals[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[..., :1], 1e10)], dim=-1)
    deltas = deltas * ray_norm(rays_d)
    if noise is not None:
        sigmas = sigmas + noise
    alphas = 1.0 - torch.exp(-deltas * torch.relu(sigmas))
    shifted = torch.cat(
        [torch.ones_like(alphas[..., :1]), 1.0 - alphas + 1e-10], dim=-1
    )
    transmittance = torch.cumprod(shifted, dim=-1)[..., :-1]
    return alphas * transmittance


def composite(
    rgbs: torch.Tensor,
    sigmas: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    white_back: bool = False,
) -> CompositeOut:
    """rgbs (N, S, 3), sigmas (N, S) -> per-ray rgb, depth and weights."""
    weights = compute_weights(sigmas, z_vals, rays_d, noise)
    rgb = torch.sum(weights[..., None] * rgbs, dim=-2)
    depth = torch.sum(weights * z_vals, dim=-1)
    if white_back:
        rgb = rgb + (1.0 - torch.sum(weights, dim=-1, keepdim=True))
    return CompositeOut(rgb=rgb, depth=depth, weights=weights)
