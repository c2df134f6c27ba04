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
indices, the projected-ray indices, the two patch corners (or, with
warp-patch rejection, the pseudo-view patch's rank among the valid origins)
and the fresh-warp angles.  A draw not passed comes from the ``torch.Generator``
given (a CPU generator: the draws are small and move to the device).

The batch dict has the reference's key schema (the keys
``training_step`` consumes):

    rays (N, 8) | rgbs (N, 3) | depth (N, 1)          random ref-view rays
    rays_proj (N, 8) | depth_proj (N, 1)              warped pseudo-view rays
    real_patch (3, psx, psy)                          ref-image patch
    rays_full (psx*psy, 8)                            pseudo-view patch rays
    warp_patch (3, psx, psy) | warp_patch_depth (psx, psy)
    depth_ray (psx*psy, 8) | depth_gt (psx*psy, 1) | depth_ray_rgb (psx*psy, 3)

``sample_batches_prefetch`` samples several steps' items in one batched
call (the trainer's ``--prefetch_batches``); ``sample_batch`` is its
one-step case and ``sample_item`` its one-item case, so that every path
runs the same code.  The host draws stay in the per-item order, and every
product of a pose is written out in a fixed order, so that a batch does
not depend on how many steps share the call.  The device is read at most
once per call: with warp-patch rejection, the counts of the valid
pseudo-patch origins, from which the ranks are drawn.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from sinnerf_tpu_torch.data import poses
from sinnerf_tpu_torch.ops.warp import last_write_winners


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
    patch_rank: Optional[torch.Tensor] = None   # () with reject_warp_patch: the rank among the valid origins


def patch_pixels(codes: torch.Tensor, cfg: SamplerConfig, width: int) -> torch.Tensor:
    """The flat pixel indices (n, psx, psy) of the strided patches at the
    origins ``codes`` (n,), each ``ll * col_limit + up``, in an image
    ``width`` pixels wide: ``img.reshape(H * W, ...)[patch_pixels(...)]``
    is JAX's ``strided_patch`` (:73) at each origin."""
    grid = ((torch.arange(cfg.psx, device=codes.device) * cfg.s_row)[:, None] * width
            + (torch.arange(cfg.psy, device=codes.device) * cfg.s_col)[None, :])
    return ((codes // cfg.col_limit) * width + codes % cfg.col_limit)[:, None, None] + grid


def _strided_sum_map(x: torch.Tensor, cfg: SamplerConfig) -> torch.Tensor:
    """(..., H, W) -> (..., row_limit, col_limit): the sum of each origin's
    strided patch, by psx + psy slice-adds (JAX ``_strided_sum_map``
    :139)."""
    rl, cl = cfg.row_limit, cfg.col_limit
    acc = sum(x[..., i * cfg.s_row : i * cfg.s_row + rl, :] for i in range(cfg.psx))
    return sum(acc[..., j * cfg.s_col : j * cfg.s_col + cl] for j in range(cfg.psy))


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


def _rotate(dirs: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``dirs @ m[..., :3, :3].T`` for dirs (..., 3), each entry a sum of
    three products in a fixed order (``poses.matmul_in_order``'s reason)."""
    d = dirs[..., None, :]
    return (d[..., 0] * m[..., :3, 0] + d[..., 1] * m[..., :3, 1]) + d[..., 2] * m[..., :3, 2]


def _rays_from_dirs(dirs: torch.Tensor, c2w: torch.Tensor, near, far) -> torch.Tensor:
    """[o, d, near, far] for camera-frame dirs (..., 3) and c2w (..., 3, 4)
    broadcast against them."""
    rays_d = _rotate(dirs, c2w)
    rays_o = c2w[..., 3].expand(rays_d.shape)
    nf = torch.stack([near, far]).expand(*rays_d.shape[:-1], 2)
    return torch.cat([rays_o, rays_d, nf], dim=-1)


def _randint(high: int, size, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.randint(0, max(int(high), 1), size, generator=generator)


def _host_long(x) -> torch.Tensor:
    return torch.as_tensor(x).reshape(-1).long().cpu()


def _to_device(idx: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """Host draws to the scene's device without waiting for the device's
    queue: a copy from pageable memory would block until the previous
    step's kernels finish."""
    if dev.type != "cuda" or idx.device == dev:
        return idx.to(dev)
    return idx.pin_memory().to(dev, non_blocking=True)


# torch.randint(0, n) takes one 32-bit draw of a CPU generator for every n
# below this (tests/test_torch_prefetch.py pins it): the rank of a pseudo
# patch can then hold its place in the stream before its range is known
RANK_RANGE = 1 << 28

# the columns of the host draws' (items, 5) tail, after the ray indices
_REAL, _REAL_GATHER, _PATCH, _PATCH_IS_RANK, _BANK = range(5)


def _sample_items(
    scene: Dict[str, torch.Tensor],
    items: Sequence[int],
    cfg: SamplerConfig,
    draws: Sequence[ItemDraws],
    generator: Optional[torch.Generator],
) -> Dict[str, torch.Tensor]:
    """Dataset items ``items`` (leaves with a leading (len(items),) axis):
    the host draws item by item, in the order one item at a time would take
    them, then every gather, warp and patch of the items at once on the
    scene's device.  The device is read at most once: the valid pseudo-patch
    origins' counts, when a rank must be drawn under ``reject_warp_patch``."""
    if cfg.reject_real_patch != "none" and "real_origins" not in scene:
        raise ValueError(
            f"cfg.reject_real_patch={cfg.reject_real_patch!r} but the scene has no 'real_origins': "
            "the dataset must call compute_real_origins(ref_image, cfg) when it builds the scene"
        )
    if cfg.reject_warp_patch and cfg.row_limit * cfg.col_limit >= RANK_RANGE:
        raise ValueError(f"{cfg.row_limit} x {cfg.col_limit} patch origins: a rank's draw would take another "
                         "share of the generator")
    gen = generator if generator is not None else torch.default_generator
    dev = scene["pool"].device
    near, far = scene["near_far"][0], scene["near_far"][1]
    h_img, w_img = scene["ref_image"].shape[:2]
    n, cl = len(items), cfg.col_limit
    n_main, n_proj = cfg.num_rays - cfg.n_any, cfg.n_proj or cfg.num_rays

    # ---- the host draws, item by item in the per-item order ---------------
    rows, angles, rank_states = [], [], {}
    for pos, (item, d) in enumerate(zip(items, draws)):
        rays = d.rays if d.rays is not None else _randint(scene["pool"].shape[0], (n_main,), gen)
        any_rays = torch.zeros(0, dtype=torch.long)
        if cfg.n_any > 0:
            any_rays = d.any_rays if d.any_rays is not None else _randint(scene["any"].shape[0], (cfg.n_any,), gen)
        proj = d.proj if d.proj is not None else _randint(scene["proj_depth"].shape[0], (n_proj,), gen)
        # the real patch: a flat origin code ll * col_limit + up, or an index
        # into real_origins that the device resolves
        if d.real_corner is not None:
            ll, up = _host_long(d.real_corner).tolist()
            real = (ll * cl + up, 0)
        elif "real_origins" in scene:
            real = (int(_randint(scene["real_origins"].shape[0], (), gen)), 1)
        else:
            ll, up = int(_randint(cfg.row_limit, (), gen)), int(_randint(cfg.col_limit, (), gen))
            real = (ll * cl + up, 0)
        if cfg.fresh_warp:
            angles.append(d.angles if d.angles is not None else torch.randn(3, generator=gen) * (cfg.angle // 2))
        # the pseudo patch: a flat origin code, or a rank among the valid
        # origins; a rank to draw keeps its place in the stream (one draw,
        # whatever its range) and is drawn from there once the range is read
        if d.patch_corner is not None:
            ll, up = _host_long(d.patch_corner).tolist()
            patch = (ll * cl + up, 0)
        elif cfg.reject_warp_patch:
            if d.patch_rank is not None:
                patch = (int(_host_long(d.patch_rank)[0]), 1)
            else:
                rank_states[pos] = gen.get_state()
                torch.randint(0, 1, (), generator=gen)
                patch = (0, 1)
        else:
            ll, up = int(_randint(cfg.row_limit, (), gen)), int(_randint(cfg.col_limit, (), gen))
            patch = (ll * cl + up, 0)
        tail = torch.tensor([*real, *patch, item % scene["bank_c2w"].shape[0]])
        rows.append(torch.cat([_host_long(rays), _host_long(any_rays), _host_long(proj), tail]))
    host = _to_device(torch.stack(rows), dev)  # one copy for the group's indices
    i_main, i_any = host[:, :n_main], host[:, n_main : cfg.num_rays]
    j, tail = host[:, cfg.num_rays : cfg.num_rays + n_proj], host[:, cfg.num_rays + n_proj :]

    # ---- 1. random ref-view rays (main pool + the blender any-pool mix) ----
    picked = scene["pool"][i_main]
    if cfg.n_any > 0:
        picked = torch.cat([picked, scene["any"][i_any]], dim=1)
    rays, rgbs, depth = picked[..., :8], picked[..., 8:11], picked[..., 11:12]

    # ---- 2. projected (warped pseudo-view) rays ----------------------------
    dirs_flat = scene["directions"].reshape(-1, 3)[scene["proj_pix"][j]]
    rays_proj = _rays_from_dirs(dirs_flat, scene["bank_c2w"][scene["proj_pose"][j]], near, far)
    depth_proj = scene["proj_depth"][j][..., None]

    # ---- 3. real (ref-image) patch, uniform over the valid origins --------
    code = tail[:, _REAL]
    if "real_origins" in scene:
        gather = tail[:, _REAL_GATHER] == 1
        code = torch.where(gather, scene["real_origins"][torch.where(gather, code, 0)].long(), code)
    rgb_flat = scene["ref_image"].reshape(-1, 3)
    real_patch = rgb_flat[patch_pixels(code, cfg, w_img)].permute(0, 3, 1, 2)

    # ---- 4. pseudo views: fresh gaussian warps (blender) or bank entries ---
    bank_i = tail[:, _BANK]
    if cfg.fresh_warp:
        dtype = scene["ref_c2w"].dtype
        ang = _to_device(torch.stack([torch.as_tensor(a).reshape(3).to(dtype) for a in angles]), dev)
        pseudo_c2w = poses.rotate_3d(scene["ref_c2w"], ang[:, 0], ang[:, 1], ang[:, 2])  # (n, 3, 4)
        ref_p = poses.projection_matrix(scene["k3"], poses.c2w_to_w2c_cv(scene["ref_c2w"]))
        src_p = poses.projection_matrix(scene["k3"], poses.c2w_to_w2c_cv(pseudo_c2w))
        # inv_ex: no read of the device to check for a singular matrix
        rel = poses.matmul_in_order(src_p, torch.linalg.inv_ex(ref_p)[0])
        win, depth_src = last_write_winners(scene["ref_depth"], rel)  # (n, H*W) each
        warp_depth = torch.where(win >= 0, torch.gather(depth_src, 1, torch.clamp(win, min=0)), 0.0)
    else:
        pseudo_c2w = scene["bank_c2w"][bank_i]
        warp_depth = None

    # ---- 5. pseudo-view patches (fake rays + warp rgb/depth) --------------
    patch_code = tail[:, _PATCH]
    if cfg.reject_warp_patch:
        # uniform over the origins whose warp-depth patch is not all zero, as
        # the reference's redraw loop (blender_rot3d.py:468-476); none valid
        # degrades to (0, 0), a fully masked patch (JAX :195-204)
        depth_map = warp_depth if warp_depth is not None else scene["bank_depth"][bank_i]
        valid = (_strided_sum_map(depth_map.reshape(n, h_img, w_img), cfg) != 0).reshape(n, -1)
        rank = patch_code
        if rank_states:
            counts = valid.sum(1).tolist()  # the group's one read of the device
            drawn = torch.zeros(n, dtype=torch.long)
            replay = torch.Generator()
            for pos, state in rank_states.items():
                replay.set_state(state)
                drawn[pos] = _randint(counts[pos], (), replay)
            rank = rank + _to_device(drawn, dev)
        origin = torch.argmax((torch.cumsum(valid.to(torch.int64), 1) > rank[:, None]).to(torch.int8), dim=1)
        patch_code = torch.where(tail[:, _PATCH_IS_RANK] == 1, origin, patch_code)
    patch_idx = patch_pixels(patch_code, cfg, w_img)  # (n, psx, psy)
    flat_idx = patch_idx.reshape(n, -1)
    dirs_patch = scene["directions"].reshape(-1, 3)[patch_idx]  # (n, psx, psy, 3)
    fake_patch = _rays_from_dirs(dirs_patch, pseudo_c2w[:, None, None], near, far).reshape(n, -1, 8)
    if cfg.fresh_warp:  # the winners' rgb, for the patches' pixels only
        win_p = torch.gather(win, 1, flat_idx).reshape(patch_idx.shape)
        warp_patch = torch.where((win_p >= 0)[..., None], rgb_flat[torch.clamp(win_p, min=0)], 0.0)
        warp_patch = warp_patch.permute(0, 3, 1, 2)
        warp_patch_depth = torch.gather(warp_depth, 1, flat_idx).reshape(patch_idx.shape)
    else:  # the banks are channel-major (P, 3, H, W)
        hw = h_img * w_img
        warp_patch_depth = scene["bank_depth"].reshape(-1)[bank_i[:, None, None] * hw + patch_idx]
        channel = (bank_i[:, None] * 3 + torch.arange(3, device=dev)) * hw  # (n, 3)
        warp_patch = scene["bank_rgb"].reshape(-1)[channel[:, :, None, None] + patch_idx[:, None]]

    # ---- 6. ref-view patches at the same origins (depth supervision) ------
    depth_ray = _rays_from_dirs(dirs_patch, scene["ref_c2w"], near, far).reshape(n, -1, 8)
    depth_gt = scene["ref_depth"].reshape(-1)[flat_idx][..., None]
    depth_ray_rgb = rgb_flat[flat_idx]

    out = {
        "rays": rays,
        "rgbs": rgbs,
        "depth": depth,
        "rays_proj": rays_proj,
        "depth_proj": depth_proj,
        "real_patch": real_patch,
        "rays_full": fake_patch,
        "warp_patch": warp_patch,
        "warp_patch_depth": warp_patch_depth,
        "depth_ray": depth_ray,
        "depth_gt": depth_gt,
        "depth_ray_rgb": depth_ray_rgb,
    }
    return {k: v.contiguous() for k, v in out.items()}


def sample_batches_prefetch(
    scene: Dict[str, torch.Tensor],
    steps: Sequence[int],
    cfg: SamplerConfig,
    batch_size: int = 1,
    generator: Optional[torch.Generator] = None,
    draws=None,
) -> Dict[str, torch.Tensor]:
    """K steps' batches in one batched call (JAX ``sample_batches_prefetch``
    :405): leaves of shape (K, batch_size, ...); slice ``[j]`` is
    ``sample_batch(scene, steps[j], ...)`` bit for bit, and the generator
    ends where the K per-step calls leave it.  ``draws``: per step, one
    ``ItemDraws`` per item, or None."""
    steps = [int(s) for s in steps]
    items = [s * batch_size + i for s in steps for i in range(batch_size)]
    flat = [d for per_step in draws for d in per_step] if draws is not None else [ItemDraws()] * len(items)
    out = _sample_items(scene, items, cfg, flat, generator)
    return {k: v.reshape(len(steps), batch_size, *v.shape[1:]) for k, v in out.items()}


def sample_batch(
    scene: Dict[str, torch.Tensor],
    step: int,
    cfg: SamplerConfig,
    batch_size: int = 1,
    generator: Optional[torch.Generator] = None,
    draws=None,
) -> Dict[str, torch.Tensor]:
    """``batch_size`` items stacked on a leading axis, as the reference's
    DataLoader collates them (JAX ``sample_batch`` :390): the one-step case
    of ``sample_batches_prefetch``; item i is the dataset's item ``step *
    batch_size + i``.  ``draws``: one ``ItemDraws`` per item, or None."""
    out = sample_batches_prefetch(scene, [step], cfg, batch_size, generator, None if draws is None else [draws])
    return {k: v[0] for k, v in out.items()}


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
    return {k: v[0] for k, v in _sample_items(scene, [item_idx], cfg, [draws], generator).items()}
