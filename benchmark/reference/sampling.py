"""Ray-depth sampling: stratified coarse samples and inverse-CDF importance
resampling.

Counterpart of ``sinnerf_tpu/core/sampling.py`` (reference
``models/rendering.py:15-61,264-282``).  Every random draw can be passed in
as a tensor; a ``torch.Generator`` is used only when none is passed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _uniform(shape, like: torch.Tensor, generator: Optional[torch.Generator]):
    return torch.rand(
        shape, generator=generator, dtype=like.dtype, device=like.device
    )


def f32_recip(n: int) -> float:
    """``1/n`` rounded to float32.  XLA turns a division by a constant into a
    multiply by its float32 reciprocal; multiplying by this value rounds as
    the JAX functions do (an ulp of ``u`` can move an importance sample by a
    whole bin where the pdf is degenerate)."""
    return float(np.float32(1.0) / np.float32(n))


def linspace01(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """``linspace(0, 1, n)`` rounded as ``jnp.linspace`` rounds it:
    ``i * f32(1/(n-1))`` with the end point exactly 1."""
    out = torch.arange(n, dtype=dtype, device=device) * f32_recip(max(n - 1, 1))
    if n > 1:
        out[-1] = 1.0
    return out


def stratified_z_vals(
    near: torch.Tensor,
    far: torch.Tensor,
    n_samples: int,
    use_disp: bool = False,
    perturb: float = 0.0,
    u: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """``n_samples`` depths per ray between near and far, (N, 1) each.

    ``use_disp`` samples linearly in disparity.  ``perturb > 0`` jitters each
    sample inside its stratum by ``perturb * u``; ``u`` (N, n_samples) is
    drawn from ``generator`` when not given.
    """
    z_steps = linspace01(n_samples, near.dtype, near.device)
    if use_disp:
        z_vals = 1.0 / (1.0 / near * (1.0 - z_steps) + 1.0 / far * z_steps)
    else:
        z_vals = near * (1.0 - z_steps) + far * z_steps
    if perturb > 0.0:
        z_mid = 0.5 * (z_vals[..., :-1] + z_vals[..., 1:])
        upper = torch.cat([z_mid, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], z_mid], dim=-1)
        if u is None:
            u = _uniform(z_vals.shape, z_vals, generator)
        z_vals = lower + (upper - lower) * (perturb * u)
    return z_vals


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_importance: int,
    det: bool = False,
    u: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    eps: float = 1e-5,
    sorted_u: bool = False,
) -> torch.Tensor:
    """Draw ``n_importance`` depths from the piecewise-constant pdf that
    ``weights`` (N, M) defines over the bin edges ``bins`` (N, M+1).

    ``det`` uses ``u = linspace(0, 1, K)``.  Otherwise ``u`` (N, K) holds
    uniforms in [0, 1), drawn from ``generator`` when not given; with
    ``sorted_u`` they become the stratified ``(arange(K) + u) / K``.
    Keeps the reference's eps regularization, right-searchsorted with
    below/above clamping, and the ``denom < eps -> 1`` guard.
    """
    n_rays, m = weights.shape
    weights = weights + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (N, M+1)

    if det:
        u = linspace01(n_importance, bins.dtype, bins.device).expand(n_rays, n_importance)
    else:
        if u is None:
            u = _uniform((n_rays, n_importance), bins, generator)
        if sorted_u:
            ar = torch.arange(n_importance, dtype=bins.dtype, device=bins.device)
            u = (ar + u) * f32_recip(n_importance)
    u = u.contiguous()

    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=m)
    cdf_lo = torch.gather(cdf, 1, below)
    cdf_hi = torch.gather(cdf, 1, above)
    bins_lo = torch.gather(bins, 1, below)
    bins_hi = torch.gather(bins, 1, above)

    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bins_lo + (u - cdf_lo) / denom * (bins_hi - bins_lo)
