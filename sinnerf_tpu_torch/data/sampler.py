"""The training-batch sampler.

Counterpart of ``sinnerf_tpu/data/sampler.py`` (reference: the per-item
numpy sampling of ``llff_ray_patch_1image_proj.py:619-669``,
``blender_ray_patch_1image_rot3d.py:443-528`` and ``dtu_proj.py:594-654``).
The scene's arrays live on the device; an item is a handful of gathers and
strided slices there.  The reference's redraw-until-valid patch loops are
kept exactly as the JAX package keeps them: the valid real-patch origins of
the static reference image are enumerated once (``compute_real_origins``),
and a fresh warp's valid pseudo-patch origins are evaluated for every
origin at once and drawn from uniformly.

Every draw of an item can be passed in (``ItemDraws``): the ray-pool
indices, the projected-ray indices, the two patch corners and the
fresh-warp angles.  A draw not passed comes from the ``torch.Generator``
given (a CPU generator: the draws are small and move to the device).

The batch dict has the reference's key schema (the keys
``training_step`` consumes):

    rays (N, 8) | rgbs (N, 3) | depth (N, 1)          random ref-view rays
    rays_proj (N, 8) | depth_proj (N, 1)              warped pseudo-view rays
    real_patch (3, psx, psy)                          ref-image patch
    rays_full (psx*psy, 8)                            pseudo-view patch rays
    warp_patch (3, psx, psy) | warp_patch_depth (psx, psy)
    depth_ray (psx*psy, 8) | depth_gt (psx*psy, 1) | depth_ray_rgb (psx*psy, 3)

``sample_batches_prefetch`` (one dispatch for several steps, a TPU
launch-overhead measure) is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from sinnerf_tpu_torch.data import poses
from sinnerf_tpu_torch.ops.warp import warp_winner


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Static sampling configuration (JAX ``SamplerConfig`` :45)."""

    height: int
    width: int
    psx: int  # patch rows
    psy: int  # patch cols
    s_row: int = 1  # row stride (the reference's sW strides the first axis)
    s_col: int = 1  # col stride (sH)
    num_rays: int = 4096
    n_any: int = 0  # blender: rays drawn from the all-pixel pool
    n_proj: int = 0  # warped-ray draw count; 0 = num_rays
    fresh_warp: bool = False  # blender rot3d: a new gaussian pseudo view per item
    angle: int = 20
    reject_real_patch: str = "none"  # 'none' | 'max_nonzero' | 'mean_gt_001'
    reject_warp_patch: bool = False

    @property
    def row_limit(self) -> int:
        # np.random.randint(0, w - (ps-1)*s - 1) upper bound (exclusive)
        return self.height - (self.psx - 1) * self.s_row - 1

    @property
    def col_limit(self) -> int:
        return self.width - (self.psy - 1) * self.s_col - 1


class ItemDraws(NamedTuple):
    """The random draws of one item; None: drawn from the generator."""

    rays: Optional[torch.Tensor] = None         # (num_rays - n_any,) indices into the pool
    any_rays: Optional[torch.Tensor] = None     # (n_any,) indices into the all-pixel pool
    proj: Optional[torch.Tensor] = None         # (n_proj,) indices into the warped-pixel index
    real_corner: Optional[torch.Tensor] = None  # (2,) row, col of the ref-image patch
    angles: Optional[torch.Tensor] = None       # (3,) fresh-warp Euler angles, degrees
    patch_corner: Optional[torch.Tensor] = None  # (2,) row, col of the pseudo-view patch


def strided_patch(img: torch.Tensor, ll: int, up: int, psx: int, psy: int, s_row: int, s_col: int):
    """``img[ll : ll+(psx-1)*s_row+1 : s_row, up : ... : s_col]`` for img
    (H, W, ...) (JAX ``strided_patch`` :73)."""
    return img[ll : ll + (psx - 1) * s_row + 1 : s_row, up : up + (psy - 1) * s_col + 1 : s_col]


def _strided_sum_map(x: torch.Tensor, cfg: SamplerConfig) -> torch.Tensor:
    """(H, W) -> (row_limit, col_limit): the sum of each origin's strided
    patch, by psx + psy slice-adds (JAX ``_strided_sum_map`` :139)."""
    rl, cl = cfg.row_limit, cfg.col_limit
    acc = sum(x[i * cfg.s_row : i * cfg.s_row + rl] for i in range(cfg.psx))
    return sum(acc[:, j * cfg.s_col : j * cfg.s_col + cl] for j in range(cfg.psy))


def compute_real_origins(ref_image: np.ndarray, cfg: SamplerConfig) -> Optional[np.ndarray]:
    """The valid real-patch origins, flat-encoded ``ll * col_limit + up``
    (int32), or None without real-patch rejection (JAX
    ``compute_real_origins`` :155, reference ``blender_rot3d.py:451-460``).
    Raises when no origin is valid (the reference would loop forever)."""
    if cfg.reject_real_patch == "none":
        return None
    rl, cl = cfg.row_limit, cfg.col_limit
    if cfg.reject_real_patch == "max_nonzero":
        red, op = ref_image.max(axis=-1), np.maximum
    elif cfg.reject_real_patch == "mean_gt_001":
        red, op = ref_image.sum(axis=-1), np.add
    else:
        raise ValueError(cfg.reject_real_patch)
    acc = None
    for i in range(cfg.psx):
        sl = red[i * cfg.s_row : i * cfg.s_row + rl, :]
        acc = sl.copy() if acc is None else op(acc, sl)
    acc2 = None
    for j in range(cfg.psy):
        sl = acc[:, j * cfg.s_col : j * cfg.s_col + cl]
        acc2 = sl.copy() if acc2 is None else op(acc2, sl)
    if cfg.reject_real_patch == "max_nonzero":
        valid = acc2 != 0
    else:
        valid = acc2 / (cfg.psx * cfg.psy * ref_image.shape[-1]) > 0.01
    ll, up = np.nonzero(valid)
    if ll.size == 0:
        raise ValueError(
            f"no valid real-patch origin: every candidate patch fails '{cfg.reject_real_patch}' "
            f"(patch {cfg.psx}x{cfg.psy} stride {cfg.s_row}x{cfg.s_col} on a {red.shape} image)"
        )
    return (ll * cl + up).astype(np.int32)


def _rays_from_dirs(dirs: torch.Tensor, c2w: torch.Tensor, near, far) -> torch.Tensor:
    """[o, d, near, far] for camera-frame dirs (..., 3) and c2w (3, 4)."""
    rays_d = dirs @ c2w[:, :3].T
    rays_o = c2w[:, 3].expand(rays_d.shape)
    nf = torch.stack([near, far]).expand(*rays_d.shape[:-1], 2)
    return torch.cat([rays_o, rays_d, nf], dim=-1)


def _randint(high: int, size, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.randint(0, max(int(high), 1), size, generator=generator)


def _to_device(idx: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """Host draws to the scene's device without waiting for the device's
    queue: a copy from pageable memory would block until the previous
    step's kernels finish."""
    if dev.type != "cuda" or idx.device == dev:
        return idx.to(dev)
    return idx.pin_memory().to(dev, non_blocking=True)


def sample_item(
    scene: Dict[str, torch.Tensor],
    item_idx: int,
    cfg: SamplerConfig,
    draws: ItemDraws = ItemDraws(),
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """Draw one training item (JAX ``sample_item`` :220).  ``scene`` is the
    dataset's bundle on the device: ref_image (H, W, 3), ref_depth (H, W),
    directions (H, W, 3), pool (N, 12) ``[o, d, near, far, rgb, depth]``
    (and ``any`` for the blender mix), proj_pose/proj_pix/proj_depth (the
    valid warped pixels), bank_c2w (P, 3, 4), bank_rgb (P, 3, H, W) and
    bank_depth (P, H, W) unless ``fresh_warp``, k3, ref_c2w, near_far, and
    real_origins when ``reject_real_patch`` is set."""
    if cfg.reject_real_patch != "none" and "real_origins" not in scene:
        raise ValueError(
            f"cfg.reject_real_patch={cfg.reject_real_patch!r} but the scene has no 'real_origins': "
            "the dataset must call compute_real_origins(ref_image, cfg) when it builds the scene"
        )
    dev = scene["pool"].device
    near, far = scene["near_far"][0], scene["near_far"][1]
    args_of = lambda ll, up: (int(ll), int(up), cfg.psx, cfg.psy, cfg.s_row, cfg.s_col)  # noqa: E731

    # ---- 1. random ref-view rays (main pool + the blender any-pool mix) ----
    n_main = cfg.num_rays - cfg.n_any
    i_main = draws.rays if draws.rays is not None else _randint(scene["pool"].shape[0], (n_main,), generator)
    picked = scene["pool"][_to_device(i_main, dev)]
    if cfg.n_any > 0:
        i_any = draws.any_rays if draws.any_rays is not None else _randint(
            scene["any"].shape[0], (cfg.n_any,), generator)
        picked = torch.cat([picked, scene["any"][_to_device(i_any, dev)]])
    rays, rgbs, depth = picked[:, :8], picked[:, 8:11], picked[:, 11:12]

    # ---- 2. projected (warped pseudo-view) rays ----------------------------
    n_proj = cfg.n_proj if cfg.n_proj else cfg.num_rays
    j = draws.proj if draws.proj is not None else _randint(scene["proj_depth"].shape[0], (n_proj,), generator)
    j = _to_device(j, dev)
    dirs_flat = scene["directions"].reshape(-1, 3)[scene["proj_pix"][j]]
    c2ws = scene["bank_c2w"][scene["proj_pose"][j]]
    rays_d = torch.einsum("nj,nij->ni", dirs_flat, c2ws[:, :, :3])
    nf = torch.stack([near, far]).expand(n_proj, 2)
    rays_proj = torch.cat([c2ws[:, :, 3], rays_d, nf], dim=-1)
    depth_proj = scene["proj_depth"][j][:, None]

    # ---- 3. real (ref-image) patch, uniform over the valid origins --------
    if draws.real_corner is not None:
        ll_r, up_r = (int(v) for v in draws.real_corner)
    elif "real_origins" in scene:
        code = int(scene["real_origins"][int(_randint(scene["real_origins"].shape[0], (), generator))])
        ll_r, up_r = code // cfg.col_limit, code % cfg.col_limit
    else:
        ll_r, up_r = int(_randint(cfg.row_limit, (), generator)), int(_randint(cfg.col_limit, (), generator))
    real_patch = strided_patch(scene["ref_image"], *args_of(ll_r, up_r)).permute(2, 0, 1)

    # ---- 4. pseudo view: a fresh gaussian warp (blender) or a bank entry ---
    if cfg.fresh_warp:
        angles = draws.angles if draws.angles is not None else torch.randn(3, generator=generator) * (cfg.angle // 2)
        angles = angles.to(device=dev, dtype=scene["ref_c2w"].dtype)
        pseudo_c2w = poses.rotate_3d(scene["ref_c2w"], *angles)
        ref_p = poses.projection_matrix(scene["k3"], poses.c2w_to_w2c_cv(scene["ref_c2w"]))
        src_p = poses.projection_matrix(scene["k3"], poses.c2w_to_w2c_cv(pseudo_c2w))
        h_img, w_img = scene["ref_depth"].shape
        win, d_flat = warp_winner(scene["ref_depth"], ref_p, src_p, zbuffer=False)
        win_map = win.reshape(h_img, w_img)
        warp_depth = torch.where(win >= 0, d_flat[torch.clamp(win, min=0)], 0.0).reshape(h_img, w_img)
    else:
        bank_i = item_idx % scene["bank_c2w"].shape[0]
        warp_rgb = scene["bank_rgb"][bank_i]  # (3, H, W)
        warp_depth = scene["bank_depth"][bank_i]
        pseudo_c2w = scene["bank_c2w"][bank_i]

    # ---- 5. pseudo-view patch (fake rays + warp rgb/depth) -----------------
    if draws.patch_corner is not None:
        ll, up = (int(v) for v in draws.patch_corner)
    elif cfg.reject_warp_patch:
        # uniform over the origins whose warp-depth patch is not all zero,
        # as the reference's redraw loop (blender_rot3d.py:468-476); none
        # valid degrades to (0, 0), a fully masked patch (JAX :195-204)
        valid = (_strided_sum_map(warp_depth, cfg) != 0).reshape(-1)
        rank = _randint(int(valid.sum()), (), generator).to(dev)
        idx = int(torch.argmax((torch.cumsum(valid.to(torch.int64), 0) > rank).to(torch.int8)))
        ll, up = idx // cfg.col_limit, idx % cfg.col_limit
    else:
        ll, up = int(_randint(cfg.row_limit, (), generator)), int(_randint(cfg.col_limit, (), generator))
    args = args_of(ll, up)
    dirs_patch = strided_patch(scene["directions"], *args)  # (psx, psy, 3)
    fake_patch = _rays_from_dirs(dirs_patch, pseudo_c2w, near, far).reshape(-1, 8)
    if cfg.fresh_warp:  # the winners' rgb, for the patch's pixels only
        win_p = strided_patch(win_map, *args)
        rgb_flat = scene["ref_image"].reshape(-1, 3)
        warp_patch = torch.where((win_p >= 0)[..., None], rgb_flat[torch.clamp(win_p, min=0)], 0.0).permute(2, 0, 1)
    else:  # the banks are channel-major (3, H, W)
        warp_patch = warp_rgb[:, ll : ll + (cfg.psx - 1) * cfg.s_row + 1 : cfg.s_row,
                              up : up + (cfg.psy - 1) * cfg.s_col + 1 : cfg.s_col]
    warp_patch_depth = strided_patch(warp_depth, *args)

    # ---- 6. ref-view patch at the same origin (depth supervision) ----------
    depth_ray = _rays_from_dirs(dirs_patch, scene["ref_c2w"], near, far).reshape(-1, 8)
    depth_gt = strided_patch(scene["ref_depth"], *args).reshape(-1, 1)
    depth_ray_rgb = strided_patch(scene["ref_image"], *args).reshape(-1, 3)

    return {
        "rays": rays,
        "rgbs": rgbs,
        "depth": depth,
        "rays_proj": rays_proj,
        "depth_proj": depth_proj,
        "real_patch": real_patch.contiguous(),
        "rays_full": fake_patch,
        "warp_patch": warp_patch.contiguous(),
        "warp_patch_depth": warp_patch_depth.contiguous(),
        "depth_ray": depth_ray,
        "depth_gt": depth_gt,
        "depth_ray_rgb": depth_ray_rgb,
    }


def sample_batch(
    scene: Dict[str, torch.Tensor],
    step: int,
    cfg: SamplerConfig,
    batch_size: int = 1,
    generator: Optional[torch.Generator] = None,
    draws=None,
) -> Dict[str, torch.Tensor]:
    """``batch_size`` items stacked on a leading axis, as the reference's
    DataLoader collates them (JAX ``sample_batch`` :390); item i is the
    dataset's item ``step * batch_size + i``.  ``draws``: one ``ItemDraws``
    per item, or None."""
    items = [
        sample_item(scene, step * batch_size + i, cfg, draws[i] if draws is not None else ItemDraws(), generator)
        for i in range(batch_size)
    ]
    return {k: torch.stack([it[k] for it in items]) for k in items[0]}
