"""Ray generation from camera intrinsics and poses.

Counterpart of ``sinnerf_tpu/core/rays.py`` (reference
``datasets/ray_utils.py``): pinhole camera, -z forward (DTU: +z forward,
y down), directions not normalized, and no +0.5 pixel-center offset; the
world-frame rays of a camera, their 8-float packing and the NDC warp.
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


def get_rays(directions: torch.Tensor, c2w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """World-frame ray origins and directions of one camera (JAX ``get_rays``
    :68, reference ``ray_utils.py:96-120``): directions (..., 3) in the camera
    frame, c2w (3, 4) -> flattened (N, 3), (N, 3).  The directions are not
    normalized: compositing scales by ``||d||``."""
    c2w = torch.as_tensor(c2w, dtype=directions.dtype, device=directions.device)
    rays_d = directions @ c2w[:, :3].T
    rays_o = c2w[:, 3].expand(rays_d.shape)
    return rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)


def make_ray_bundle(directions: torch.Tensor, c2w: torch.Tensor, near: float, far: float) -> torch.Tensor:
    """Rays packed as ``[o(3), d(3), near, far]`` (N, 8) (JAX :82, reference
    ``blender_rot3d.py:310-313``)."""
    rays_o, rays_d = get_rays(directions, c2w)
    near_col = torch.full_like(rays_o[:, :1], near)
    far_col = torch.full_like(rays_o[:, :1], far)
    return torch.cat([rays_o, rays_d, near_col, far_col], dim=-1)


def get_ndc_rays(h: int, w: int, focal: float, near: float, rays_o: torch.Tensor,
                 rays_d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays shifted to the near plane and projected into NDC (JAX :96,
    reference ``ray_utils.py:123-164``); the SinNeRF recipes run with
    ``ndc=False``."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]
    o0 = -1.0 / (w / (2.0 * focal)) * ox_oz
    o1 = -1.0 / (h / (2.0 * focal)) * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (w / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -1.0 / (h / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2
    return torch.stack([o0, o1, o2], dim=-1), torch.stack([d0, d1, d2], dim=-1)
