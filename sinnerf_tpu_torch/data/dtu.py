"""DTU MVS single-image dataset.

Counterpart of ``sinnerf_tpu/data/dtu.py`` (reference ``MVSDatasetDTU_proj``,
``datasets/dtu_proj.py:276-662``): reference view 2 under light 3, depth from
MVSNet's PFM upsampled 4x, world scale 1/200, pseudo views from the
``Cameras/pair.txt`` source list, z-buffered warp with full K @ E
projections.  The cam files are parsed with ``np.fromstring`` and the depth
resized by ``cv2``, as in the JAX package, so both read the same bits.  As
there, K follows ``--img_wh`` from the on-disk image size (the reference
keeps the native intrinsics at any size) and no debug images are written.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import cv2
import numpy as np
import torch

from sinnerf_tpu_torch.core.rays import get_ray_directions_pz
from sinnerf_tpu_torch.data.base import (
    SingleImageDataset,
    build_proj_index,
    build_warp_banks,
    load_image,
    pack_rays_np,
)
from sinnerf_tpu_torch.data.depth_io import read_pfm
from sinnerf_tpu_torch.data.sampler import SamplerConfig, compute_real_origins

SCALE_FACTOR = 1.0 / 200  # dtu_proj.py:290
LIGHT_IDX = 3  # dtu_proj.py:299
REF_VIEW_ID = 2  # dtu_proj.py:300


def read_cam_file(filename: str, scale_factor: float = SCALE_FACTOR):
    """Parse a DTU cam file -> (intrinsics (3, 3), extrinsics (4, 4) w2c,
    (near, far)).  dtu_proj.py:384-400; near/far = depth_min + 192 *
    interval, both world-scaled."""
    with open(filename) as f:
        lines = [line.rstrip() for line in f.readlines()]
    extrinsics = np.fromstring(" ".join(lines[1:5]), dtype=np.float32, sep=" ").reshape(4, 4)
    intrinsics = np.fromstring(" ".join(lines[7:10]), dtype=np.float32, sep=" ").reshape(3, 3)
    depth_min = float(lines[11].split()[0]) * scale_factor
    depth_max = depth_min + float(lines[11].split()[1]) * 192 * scale_factor
    return intrinsics, extrinsics, (depth_min, depth_max)


def read_pair_file(filename: str, ref_id: int) -> List[int]:
    """The source-view list of ``ref_id`` in pair.txt (dtu_proj.py:318-333)."""
    with open(filename) as f:
        num_viewpoint = int(f.readline())
        for _ in range(num_viewpoint):
            ref_view = int(f.readline().rstrip())
            src_views = [int(x) for x in f.readline().rstrip().split()[1::2]]
            if ref_view == ref_id:
                return src_views
    raise ValueError(f"view {ref_id} not found in {filename}")


class DTUProj(SingleImageDataset):
    dataset_name = "dtu_proj"

    def __init__(
        self,
        root_dir: str,
        split: str = "train",
        img_wh: Tuple[int, int] = (640, 512),
        scan: int = 4,
        patch_size_x: int = 56,
        patch_size_y: int = 70,
        sW: int = 1,
        sH: int = 1,
        num_rays: int = 4096,
        ref_view_id: int = REF_VIEW_ID,
        light_idx: int = LIGHT_IDX,
        device: torch.device = torch.device("cpu"),
        **kwargs,
    ):
        from PIL import Image

        self.root_dir = root_dir
        self.split = split
        self.img_wh = img_wh
        self.scan = scan
        self.white_back = True  # dtu_proj.py:312
        w, h = img_wh

        def img_path(vid):
            return os.path.join(root_dir, f"Rectified/scan{scan}_train/rect_{vid + 1:03d}_{light_idx}_r5000.png")

        def depth_path(vid):
            return os.path.join(root_dir, "MVSNet_pytorch_outputs/",
                                f"scan{scan}/depth_est/rect_{vid + 1:03d}_{light_idx}_r5000.pfm")

        self._img_path, self._depth_path = img_path, depth_path
        # the x4 cam-file calibration is native at the on-disk image size
        # (640x512 for distributed DTU): a header read, no decode
        self._cam_native_wh = Image.open(img_path(ref_view_id)).size

        intrinsic, extrinsic, (self.near, self.far) = self._load_cam(ref_view_id)
        self.k3 = intrinsic
        self.ref_w2c = extrinsic
        self.ref_c2w = np.linalg.inv(extrinsic)
        self.src_views = read_pair_file(os.path.join(root_dir, "Cameras/pair.txt"), ref_view_id)
        self.focal = [intrinsic[0, 0], intrinsic[1, 1]]
        self.directions = get_ray_directions_pz(h, w, intrinsic).numpy()

        if split == "train":
            self._build_train(ref_view_id, patch_size_x, patch_size_y, sW, sH, num_rays, torch.device(device))
        else:
            # val/test render the ref pose then every src pose (dtu_proj.py:511,533)
            self.val_rays, self.val_rgbs = [], []
            for vid, c2w in self._val_poses(ref_view_id):
                self.val_rays.append(pack_rays_np(self.directions, c2w[:3, :4], self.near, self.far))
                self.val_rgbs.append(load_image(img_path(vid), img_wh, resample="bilinear").reshape(-1, 3))
            self.length = len(self.val_rays)

    def _load_cam(self, vid: int):
        """One MVS cam file: x4 to full resolution (the files hold 1/4-res
        intrinsics, dtu_proj.py:346), the calibration rescaled from the
        on-disk image size to ``img_wh``, the translation world-scaled."""
        intrinsic, extrinsic, bounds = read_cam_file(os.path.join(self.root_dir, f"Cameras/train/{vid:08d}_cam.txt"))
        intrinsic = intrinsic.copy()
        intrinsic[:2] *= 4
        w, h = self.img_wh
        intrinsic[0] *= w / self._cam_native_wh[0]
        intrinsic[1] *= h / self._cam_native_wh[1]
        extrinsic = extrinsic.copy()
        extrinsic[:3, 3] *= SCALE_FACTOR
        return intrinsic, extrinsic, bounds

    def _val_poses(self, ref_view_id):
        return [(ref_view_id, self.ref_c2w)] + [(vid, np.linalg.inv(self._load_cam(vid)[1])) for vid in self.src_views]

    def _read_depth(self, vid: int) -> np.ndarray:
        depth, _ = read_pfm(self._depth_path(vid))
        depth = cv2.resize(depth.astype(np.float32), None, fx=4, fy=4, interpolation=cv2.INTER_LINEAR)
        return depth * SCALE_FACTOR

    def _build_train(self, ref_view_id, psx, psy, sW, sH, num_rays, device):
        w, h = self.img_wh
        ref_image = load_image(self._img_path(ref_view_id), self.img_wh, resample="bilinear")
        ref_depth = self._read_depth(ref_view_id)
        if ref_depth.shape != (h, w):
            ref_depth = cv2.resize(ref_depth, (w, h), interpolation=cv2.INTER_LINEAR)
        rays = pack_rays_np(self.directions, self.ref_c2w[:3, :4], self.near, self.far)

        # src poses and full K @ E projections (dtu_proj.py:351-352)
        ref_proj = np.eye(4)
        ref_proj[:3, :4] = self.k3 @ self.ref_w2c[:3, :4]
        bank_c2w, src_projs = [], []
        for vid in self.src_views:
            intr, ext, _ = self._load_cam(vid)
            p = np.eye(4)
            p[:3, :4] = intr @ ext[:3, :4]
            src_projs.append(p)
            bank_c2w.append(np.linalg.inv(ext)[:3, :4])
        bank_c2w = np.stack(bank_c2w).astype(np.float32)
        bank_rgb, bank_depth = build_warp_banks(ref_image, ref_depth, ref_proj, np.stack(src_projs), zbuffer=True,
                                                device=device)
        proj_pose, proj_pix, proj_depth = build_proj_index(bank_rgb, bank_depth)

        scene = {
            "ref_image": ref_image,
            "ref_depth": ref_depth.astype(np.float32),
            "directions": self.directions.astype(np.float32),
            # (N, 12) [o, d, near, far, rgb, depth]; banks channel-major (P, 3, H, W)
            "pool": np.concatenate([rays, ref_image.reshape(-1, 3), ref_depth.reshape(-1, 1)], -1).astype(np.float32),
            "proj_pose": proj_pose,
            "proj_pix": proj_pix,
            "proj_depth": proj_depth,
            "bank_c2w": bank_c2w,
            "bank_rgb": bank_rgb.astype(np.float32).transpose(0, 3, 1, 2),
            "bank_depth": bank_depth.astype(np.float32),
            "k3": self.k3.astype(np.float32),
            "ref_c2w": self.ref_c2w[:3, :4].astype(np.float32),
            "near_far": np.array([self.near, self.far], np.float32),
        }
        self.cfg = SamplerConfig(height=h, width=w, psx=psx, psy=psy, s_row=sW, s_col=sH, num_rays=num_rays,
                                 reject_real_patch="mean_gt_001")
        origins = compute_real_origins(ref_image, self.cfg)
        if origins is not None:
            scene["real_origins"] = origins
        self.scene = self._finalize_scene(scene, device)
        self.length = len(bank_c2w)
        self.val_rays, self.val_rgbs = [], []
