"""Depth-based forward warping as scatters over the pixels.

Counterpart of ``sinnerf_tpu/ops/warp.py`` (reference: the LLFF painter's
loop ``datasets/llff_ray_patch_1image_proj.py:144-166``, the DTU one
``dtu_proj.py:236-273`` and the blender last-write warp
``blender_ray_patch_1image_rot3d.py:103-150``).  In JAX this is an XLA
scatter, not a Pallas kernel; here it is plain PyTorch: one
``scatter_reduce`` per warp, or per group of the sampler's fresh warps
(``last_write_winners``).

The z-buffered warp resolves every collision in one ``amin`` over a packed
64-bit key per splat, ``(depth bits << 32) | source ordinal``: a positive
float32's bits order as the float does, so the minimum is the nearest depth
and, among equal depths, the first writer, exactly the reference painter's
strict ``>`` (JAX ``warp.py:87-94``).  A non-positive depth never wins.
"""

from __future__ import annotations

from typing import Tuple

import torch


def project_pixels(
    depth_ref: torch.Tensor, ref_proj: torch.Tensor, src_proj: torch.Tensor, eps: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project every reference pixel into the source view through its depth:
    depth_ref (H, W), ref_proj/src_proj (4, 4) pixel projections ->
    (x_src, y_src, depth_src), each (H, W) (JAX ``project_pixels`` :29)."""
    h, w = depth_ref.shape
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=depth_ref.dtype, device=depth_ref.device),
        torch.arange(w, dtype=depth_ref.dtype, device=depth_ref.device),
        indexing="ij",
    )
    d = depth_ref.reshape(-1)
    pts = torch.stack([xx.reshape(-1) * d, yy.reshape(-1) * d, d, torch.ones_like(d)], dim=0)
    rel = src_proj.to(depth_ref.dtype) @ torch.linalg.inv(ref_proj.to(depth_ref.dtype))
    x_src_h = rel @ pts
    depth_src = x_src_h[2]
    x_src = x_src_h[0] / (depth_src + eps)
    y_src = x_src_h[1] / (depth_src + eps)
    return x_src.reshape(h, w), y_src.reshape(h, w), depth_src.reshape(h, w)


def _target_pixels(x_src: torch.Tensor, y_src: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The flat target pixel of each splat: floor and clamp to the image, as
    np.floor/np.clip in every reference variant.  A pixel of depth 0 seen
    from its own camera projects to 0/0: XLA converts that NaN to 0 (JAX
    :101-102), so it lands on pixel 0 here too (a NaN's conversion to an
    integer is undefined in torch)."""
    tx = torch.clamp(torch.nan_to_num(torch.floor(x_src), nan=0.0), 0, w - 1).to(torch.int64)
    ty = torch.clamp(torch.nan_to_num(torch.floor(y_src), nan=0.0), 0, h - 1).to(torch.int64)
    return ty * w + tx


def warp_winner(
    depth_ref: torch.Tensor, ref_proj: torch.Tensor, src_proj: torch.Tensor, zbuffer: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The source pixel that wins each target pixel, without moving values
    (JAX ``warp_winner`` :66).  Returns ``(win, d_flat)``: ``win`` (H*W,)
    int64, per flattened target pixel the row-major source ordinal whose
    splat wins (-1 where none lands); ``d_flat`` (H*W,) every source pixel's
    projected depth.  ``zbuffer`` keeps the nearest positive depth, first
    writer on ties; without it the last-written (largest) ordinal wins."""
    h, w = depth_ref.shape
    n = h * w
    x_src, y_src, depth_src = project_pixels(depth_ref, ref_proj, src_proj)
    flat = _target_pixels(x_src.reshape(-1), y_src.reshape(-1), h, w)
    d_flat = depth_src.reshape(-1)
    ordinal = torch.arange(n, dtype=torch.int64, device=depth_ref.device)
    if zbuffer:
        bits = d_flat.float().view(torch.int32).to(torch.int64)
        key = torch.where(d_flat > 0, (bits << 32) | ordinal, torch.iinfo(torch.int64).max)
        best = torch.full((n,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=depth_ref.device)
        best = best.scatter_reduce(0, flat, key, "amin")
        win = torch.where(best < torch.iinfo(torch.int64).max, best & 0xFFFFFFFF, -1)
    else:
        win = torch.full((n,), -1, dtype=torch.int64, device=depth_ref.device)
        win = win.scatter_reduce(0, flat, ordinal, "amax")
    return win, d_flat


def last_write_winners(depth_ref: torch.Tensor, rel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``warp_winner(..., zbuffer=False)`` for N views at once, the sampler's
    fresh warps: depth_ref (H, W) and ``rel`` (N, 4, 4), each view's
    ``src_proj @ inv(ref_proj)``.  Returns ``(win, depth_src)``, each (N,
    H*W).  Each projected coordinate is a sum of four products in a fixed
    order and every splat lands in one scatter over ``target + view * H *
    W``, so a view's winners and depths do not depend on N."""
    h, w = depth_ref.shape
    n = h * w
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=depth_ref.dtype, device=depth_ref.device),
        torch.arange(w, dtype=depth_ref.dtype, device=depth_ref.device),
        indexing="ij",
    )
    d = depth_ref.reshape(-1)
    pts = (xx.reshape(-1) * d, yy.reshape(-1) * d, d)
    rel = rel.to(depth_ref.dtype)

    def row(r):
        return ((rel[:, r, 0:1] * pts[0] + rel[:, r, 1:2] * pts[1]) + rel[:, r, 2:3] * pts[2]) + rel[:, r, 3:4]

    depth_src = row(2)
    flat = _target_pixels(row(0) / depth_src, row(1) / depth_src, h, w)
    views = rel.shape[0]
    flat = flat + torch.arange(views, device=flat.device)[:, None] * n
    ordinal = torch.arange(n, dtype=torch.int64, device=depth_ref.device).expand(views, n)
    win = torch.full((views * n,), -1, dtype=torch.int64, device=depth_ref.device)
    win = win.scatter_reduce(0, flat.reshape(-1), ordinal.reshape(-1), "amax")
    return win.reshape(views, n), depth_src


def forward_warp(
    data: torch.Tensor, depth_ref: torch.Tensor, ref_proj: torch.Tensor, src_proj: torch.Tensor,
    zbuffer: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp ``data`` (H, W, C) from the reference view into the source view
    through the reference depth (JAX ``forward_warp`` :122).  Returns
    (warped (H, W, C), warped depth (H, W)); unwritten pixels are 0."""
    h, w = depth_ref.shape
    win, d_flat = warp_winner(depth_ref, ref_proj, src_proj, zbuffer)
    valid = win >= 0
    src = torch.clamp(win, min=0)
    out = torch.where(valid[:, None], data.reshape(h * w, -1)[src], 0.0)
    out_depth = torch.where(valid, d_flat[src].to(data.dtype), 0.0)
    return out.reshape(h, w, -1), out_depth.reshape(h, w)


def warp_valid_mask(warped_rgb: torch.Tensor) -> torch.Tensor:
    """The reference's hole mask: a warped pixel is valid iff its RGB sum is
    nonzero (JAX ``warp_valid_mask`` :149)."""
    return torch.sum(warped_rgb, dim=-1) != 0
