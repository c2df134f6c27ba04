"""Ray generation from camera intrinsics.

Counterpart of ``sinnerf_tpu/core/rays.py`` (reference
``datasets/ray_utils.py``): pinhole camera, -z forward (DTU: +z forward,
y down), directions not normalized, and no +0.5 pixel-center offset.
"""

from __future__ import annotations

from typing import Tuple

import torch


def pixel_grid(
    h: int, w: int, n_h: int = -1, n_w: int = -1, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(i, j) pixel coordinates of shape (H, W), or (n_h, n_w) when sparse
    sampling is requested."""
    if n_h != -1 and n_w != -1:
        ys = torch.linspace(0.0, h - 1.0, n_h, device=device)
        xs = torch.linspace(0.0, w - 1.0, n_w, device=device)
    else:
        ys = torch.arange(h, dtype=torch.float32, device=device)
        xs = torch.arange(w, dtype=torch.float32, device=device)
    jj, ii = torch.meshgrid(ys, xs, indexing="ij")
    return ii, jj


def get_ray_directions(
    h: int, w: int, focal: float, n_h: int = -1, n_w: int = -1, device=None
) -> torch.Tensor:
    """Per-pixel camera-frame directions (H, W, 3), OpenGL convention."""
    ii, jj = pixel_grid(h, w, n_h, n_w, device)
    # an elementwise float32 division, as JAX does; a Python-scalar divisor
    # may take another rounding path
    f = torch.full_like(ii, float(focal))
    return torch.stack(
        [(ii - w / 2) / f, -(jj - h / 2) / f, -torch.ones_like(ii)],
        dim=-1,
    )


def get_ray_directions_pz(h: int, w: int, k3) -> torch.Tensor:
    """Per-pixel camera-frame directions (H, W, 3), DTU/MVS convention (x
    right, y down, +z forward), the principal point from the intrinsics
    ``k3`` (3, 3) (JAX ``get_ray_directions_pz``, reference
    ``dtu_proj.py:17-35``).  K is taken in float32, as JAX takes it."""
    k = torch.as_tensor(k3).to(torch.float32)
    ii, jj = pixel_grid(h, w, device=k.device)
    # elementwise float32 divisions by K's float32 entries, as JAX divides
    fx, fy = k[0, 0].expand_as(ii).contiguous(), k[1, 1].expand_as(ii).contiguous()
    return torch.stack([(ii - k[0, 2]) / fx, (jj - k[1, 2]) / fy, torch.ones_like(ii)], dim=-1)
