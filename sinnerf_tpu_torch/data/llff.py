"""LLFF (forward-facing capture) eval dataset.

Counterpart of ``sinnerf_tpu/data/llff.py:41-92,252-322`` (the classic
nerf_pl loader, reference ``datasets/llff.py``): val = the center image,
test_train = every real pose, test = the spiral (or spheric) path.
"""

from __future__ import annotations

import glob
import os
from typing import Tuple

import numpy as np

from sinnerf_tpu_torch.core.rays import get_ray_directions
from sinnerf_tpu_torch.data import poses as pose_np
from sinnerf_tpu_torch.data.base import EvalDataset, load_image, pack_rays_np


def _read_poses_bounds(root_dir: str):
    """Parse poses_bounds.npy -> (poses (N,3,4) centered, bounds (N,2), focal,
    near, far, val_idx, ref_idx, scale_factor).  llff_proj.py:353-404."""
    poses_bounds = np.load(os.path.join(root_dir, "poses_bounds.npy"))
    poses = poses_bounds[:, :15].reshape(-1, 3, 5)
    bounds = poses_bounds[:, -2:].copy()
    focal_raw = poses[0, :, -1]  # (H, W, focal)
    # "down right back" -> "right up back"
    poses = np.concatenate([poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], -1)
    poses, _ = pose_np.center_poses(poses)
    val_idx = int(np.argmin(np.linalg.norm(poses[..., 3], axis=1)))
    ref_idx = val_idx - 1
    near_original = bounds.min()
    scale_factor = near_original * 0.75
    bounds /= scale_factor
    poses = poses.copy()
    poses[..., 3] /= scale_factor
    near = near_original * 0.9 / scale_factor
    far = bounds.max()
    return poses, bounds, focal_raw, near, far, val_idx, ref_idx, scale_factor


def _image_paths(root_dir: str, n_poses: int = None):
    """All images as one sorted list across extensions; ``n_poses`` checks
    the sorted-filename <-> pose pairing."""
    paths = sorted(
        {
            p
            for ext in ("*.JPG", "*.jpg", "*.jpeg", "*.png", "*.PNG")
            for p in glob.glob(os.path.join(root_dir, "images", ext))
        }
    )
    if n_poses is not None and len(paths) != n_poses:
        raise ValueError(
            f"{root_dir}/images has {len(paths)} images but poses_bounds.npy "
            f"has {n_poses} rows — the sorted-filename <-> pose pairing "
            f"would be wrong"
        )
    return paths


def _eval_near_far(spheric_poses: bool, bounds, near, far):
    """Val/test near-far: the spheric branch uses near = bounds.min(),
    far = min(8 near, bounds.max()) (llff.py:364-366); otherwise the
    DSNeRF pair."""
    if spheric_poses:
        near = float(bounds.min())
        return near, min(8 * near, float(bounds.max()))
    return near, far


class LLFFEval(EvalDataset):
    dataset_name = "llff"

    def __init__(
        self,
        root_dir: str,
        split: str = "val",
        img_wh: Tuple[int, int] = (504, 378),
        spheric_poses: bool = False,
        val_num: int = 1,
        **kwargs,
    ):
        self.root_dir = root_dir
        self.split = split
        self.img_wh = img_wh
        self.white_back = False
        w, h = img_wh

        (
            self.poses,
            self.bounds,
            (h0, w0, focal0),
            self.near,
            self.far,
            self.val_idx,
            _,
            _,
        ) = _read_poses_bounds(root_dir)
        self.image_paths = _image_paths(root_dir, n_poses=len(self.poses))
        self.focal = focal0 * w / w0
        self.directions = get_ray_directions(h, w, self.focal).numpy()

        near, far = _eval_near_far(spheric_poses, self.bounds, self.near, self.far)
        if split == "val":
            # val_num > 1 repeats the center image (reference llff.py:170)
            val_num = max(1, val_num)
            rays = pack_rays_np(self.directions, self.poses[self.val_idx], near, far)
            rgbs = load_image(self.image_paths[self.val_idx], img_wh).reshape(-1, 3)
            self.val_rays = [rays] * val_num
            self.val_rgbs = [rgbs] * val_num
        elif split == "test_train":
            self.val_rays = [pack_rays_np(self.directions, p, near, far) for p in self.poses]
            self.val_rgbs = [load_image(p, img_wh).reshape(-1, 3) for p in self.image_paths]
            # renders are named after the source images (llff.py:391-392)
            self.val_fnames = list(self.image_paths)
        else:
            if not spheric_poses:
                radii = np.percentile(np.abs(self.poses[..., 3]), 90, axis=0)
                poses_test = pose_np.create_spiral_poses(radii, 3.5)
            else:
                poses_test = pose_np.create_spheric_poses(1.1 * self.bounds.min())
            self.val_rays = [pack_rays_np(self.directions, p, near, far) for p in poses_test]
            self.val_rgbs = None


dataset_dict = {"llff": LLFFEval}
