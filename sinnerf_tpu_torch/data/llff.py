"""LLFF (forward-facing capture) datasets.

Counterpart of ``sinnerf_tpu/data/llff.py``:

* ``LLFFProj`` (:95, reference ``datasets/llff_ray_patch_1image_proj.py:
  322-711``): single-image training.  The pseudo views are the other real
  camera poses, warped into with the z-buffered painter's warp; val renders
  every real pose, test the spiral (or spheric) path, ``*train`` the real
  poses.
* ``LLFFEval`` (:252, the classic nerf_pl loader, reference
  ``datasets/llff.py``): val = the center image, test_train = every real
  pose, test = the spiral (or spheric) path.

As in the JAX package, K is built with the principal point at
``((W-1)/2, (H-1)/2)`` (the reference swaps the two coordinates,
``llff_proj.py:375-376``) while the ray grid centres at ``W/2``.
"""

from __future__ import annotations

import glob
import os
from typing import Tuple

import numpy as np

import torch

from sinnerf_tpu_torch.core.rays import get_ray_directions
from sinnerf_tpu_torch.data import poses as pose_np
from sinnerf_tpu_torch.data.base import (
    EvalDataset,
    SingleImageDataset,
    build_proj_index,
    build_warp_banks,
    load_image,
    pack_rays_np,
)
from sinnerf_tpu_torch.data.sampler import SamplerConfig


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


def _proj(k3: np.ndarray, c2w: np.ndarray) -> np.ndarray:
    """The float64 pixel projection of a camera (K @ OpenCV w2c)."""
    c2w = torch.as_tensor(np.asarray(c2w, dtype=np.float64))
    return pose_np.projection_matrix(torch.as_tensor(k3, dtype=torch.float64), pose_np.c2w_to_w2c_cv(c2w)).numpy()


class LLFFProj(SingleImageDataset):
    dataset_name = "llff_ray_patch_1image_proj"

    def __init__(
        self,
        root_dir: str,
        split: str = "train",
        img_wh: Tuple[int, int] = (504, 378),
        spheric_poses: bool = False,
        patch_size_x: int = 63,
        patch_size_y: int = 84,
        sW: int = 1,
        sH: int = 1,
        depth_type: str = "nerf",
        num_rays: int = 4096,
        device: torch.device = torch.device("cpu"),
        **kwargs,
    ):
        self.root_dir = root_dir
        self.split = split
        self.img_wh = img_wh
        self.spheric_poses = spheric_poses
        self.white_back = False
        w, h = img_wh

        (
            self.poses,
            self.bounds,
            (h0, w0, focal0),
            self.near,
            self.far,
            self.val_idx,
            self.ref_idx,
            self.scale_factor,
        ) = _read_poses_bounds(root_dir)
        self.image_paths = _image_paths(root_dir, n_poses=len(self.poses))
        self.focal = focal0 * w / w0
        self.k3 = np.array([[self.focal, 0, (w - 1) / 2], [0, self.focal, (h - 1) / 2], [0, 0, 1.0]],
                           dtype=np.float32)
        self.directions = get_ray_directions(h, w, self.focal).numpy()

        near, far = _eval_near_far(spheric_poses, self.bounds, self.near, self.far)
        if split == "train":
            self._build_train(depth_type, patch_size_x, patch_size_y, sW, sH, num_rays, torch.device(device))
        elif split == "val":  # every real pose
            self.val_rays = [pack_rays_np(self.directions, p, near, far) for p in self.poses]
            self.val_rgbs = [load_image(p, img_wh).reshape(-1, 3) for p in self.image_paths]
            self.length = len(self.poses)
        else:  # the parametric test path (llff_proj.py:592-603)
            if split.endswith("train"):  # the real camera poses
                poses_test = self.poses
                self.val_rgbs = [load_image(p, img_wh).reshape(-1, 3) for p in self.image_paths]
            elif not spheric_poses:
                radii = np.percentile(np.abs(self.poses[..., 3]), 90, axis=0)
                poses_test = pose_np.create_spiral_poses(radii, 3.5)
                self.val_rgbs = None
            else:
                poses_test = pose_np.create_spheric_poses(1.1 * self.bounds.min())
                self.val_rgbs = None
            self.val_rays = [pack_rays_np(self.directions, p, near, far) for p in poses_test]
            self.length = len(poses_test)

    def _build_train(self, depth_type, psx, psy, sW, sH, num_rays, device):
        w, h = self.img_wh
        ref_c2w = self.poses[self.ref_idx]
        self.ref_c2w = ref_c2w
        ref_image = load_image(self.image_paths[self.ref_idx], self.img_wh)
        ref_depth = self._load_depth(depth_type)
        rays = pack_rays_np(self.directions, ref_c2w, self.near, self.far)

        # pseudo views = every real camera pose (llff_proj.py:522)
        bank_c2w = self.poses.astype(np.float32)
        src_projs = np.stack([_proj(self.k3, c) for c in bank_c2w])
        bank_rgb, bank_depth = build_warp_banks(ref_image, ref_depth, _proj(self.k3, ref_c2w), src_projs,
                                                zbuffer=True, device=device)
        proj_pose, proj_pix, proj_depth = build_proj_index(bank_rgb, bank_depth)
        scene = {
            "ref_image": ref_image,
            "ref_depth": ref_depth,
            "directions": self.directions.astype(np.float32),
            # (N, 12) [o, d, near, far, rgb, depth]; banks channel-major (P, 3, H, W)
            "pool": np.concatenate([rays, ref_image.reshape(-1, 3), ref_depth.reshape(-1, 1)], -1).astype(np.float32),
            "proj_pose": proj_pose,
            "proj_pix": proj_pix,
            "proj_depth": proj_depth,
            "bank_c2w": bank_c2w,
            "bank_rgb": bank_rgb.astype(np.float32).transpose(0, 3, 1, 2),
            "bank_depth": bank_depth.astype(np.float32),
            "k3": self.k3,
            "ref_c2w": ref_c2w.astype(np.float32),
            "near_far": np.array([self.near, self.far], np.float32),
        }
        self.scene = self._finalize_scene(scene, device)
        self.cfg = SamplerConfig(height=h, width=w, psx=psx, psy=psy, s_row=sW, s_col=sH, num_rays=num_rays)
        self.length = len(bank_c2w)
        self.val_rays, self.val_rgbs = [], []

    def _load_depth(self, depth_type: str) -> np.ndarray:
        base = os.path.basename(self.image_paths[self.ref_idx])
        if depth_type == "nerf":
            path = os.path.join(self.root_dir, "depth_nerf", os.path.splitext(base)[0] + ".npy")
            if not os.path.exists(path):  # reference naming: 'x.JPG' -> 'x.npy'
                path = os.path.join(self.root_dir, "depth_nerf", base.replace(".JPG", ".npy"))
        else:
            path = os.path.join(self.root_dir, "depth", base + ".npy")
        return np.load(path).astype(np.float32)


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

