"""Alpha compositing (volume-rendering quadrature).

Counterpart of ``sinnerf_tpu/core/composite.py`` (reference
``models/rendering.py:214-248``): the 1e10 cap on the last interval, deltas
scaled by the unnormalized ``||d||``, optional sigma noise, the
exclusive-cumprod transmittance with its ``+1e-10`` guard, and the white
background.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class CompositeOut(NamedTuple):
    rgb: torch.Tensor      # (N, 3)
    depth: torch.Tensor    # (N,)
    weights: torch.Tensor  # (N, S)


def ray_norm(rays_d: torch.Tensor) -> torch.Tensor:
    """``||d||`` as (N, 1), summed in channel order like the kernel does."""
    sq = rays_d * rays_d
    return torch.sqrt(sq[:, 0:1] + sq[:, 1:2] + sq[:, 2:3])


def intervals(z_vals: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    """``(z_{s+1} - z_s) * ||d||`` (N, S), with ``1e10 * ||d||`` on the last."""
    deltas = z_vals[..., 1:] - z_vals[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[..., :1], 1e10)], dim=-1)
    return deltas * ray_norm(rays_d)


def compute_alphas_weights(
    sigmas: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``alpha_i = 1 - exp(-delta_i relu(sigma_i))`` and
    ``w_i = alpha_i * prod_{j<i} (1 - alpha_j + 1e-10)``, both (N, S).

    sigmas/z_vals (N, S); rays_d (N, 3) unnormalized.  ``noise`` (N, S), when
    given, is added to sigma before the ReLU (the caller scales it by
    ``noise_std``).
    """
    if noise is not None:
        sigmas = sigmas + noise
    alphas = 1.0 - torch.exp(-intervals(z_vals, rays_d) * torch.relu(sigmas))
    shifted = torch.cat(
        [torch.ones_like(alphas[..., :1]), 1.0 - alphas + 1e-10], dim=-1
    )
    transmittance = torch.cumprod(shifted, dim=-1)[..., :-1]
    return alphas, alphas * transmittance


def compute_weights(
    sigmas: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The compositing weights of ``compute_alphas_weights``."""
    return compute_alphas_weights(sigmas, z_vals, rays_d, noise)[1]


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
