"""Shared machinery of the datasets.

Counterpart of ``sinnerf_tpu/data/base.py``: ray packing, image loading, the
``val_len``/``val_item`` API, and for the single-image training datasets the
pseudo-view warp banks (``build_warp_banks`` :30), the flat index of their
valid pixels (``build_proj_index`` :51) and ``SingleImageDataset``, whose
scene bundle lives on the device and feeds ``sampler.sample_batch`` (one
step) and ``sampler.sample_batches_prefetch`` (several).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sinnerf_tpu_torch.data.sampler import SamplerConfig, sample_batch, sample_batches_prefetch
from sinnerf_tpu_torch.ops.warp import forward_warp


def pack_rays_np(
    directions: np.ndarray, c2w: np.ndarray, near: float, far: float
) -> np.ndarray:
    """Host-side [o, d, near, far] packing; directions (..., 3), c2w (3, 4)."""
    d = directions.reshape(-1, 3) @ np.asarray(c2w)[:3, :3].T
    o = np.broadcast_to(np.asarray(c2w)[:3, 3], d.shape)
    nf = np.broadcast_to(np.array([near, far], np.float32), (d.shape[0], 2))
    return np.concatenate([o, d, nf], axis=-1).astype(np.float32)


def load_image(path: str, img_wh: Tuple[int, int], resample: str = "lanczos",
               blend_alpha_to_white: bool = False) -> np.ndarray:
    """Load and resize (``resample``: "lanczos" or "bilinear") an image to
    (H, W, 3) float32 in [0, 1]; an RGBA image is blended onto white when
    asked (the Blender sets, ``blender_rot3d.py:291``)."""
    from PIL import Image

    filt = Image.LANCZOS if resample == "lanczos" else Image.BILINEAR
    img = Image.open(path).resize(img_wh, filt)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if blend_alpha_to_white and arr.shape[-1] == 4:
        rgb, a = arr[..., :3], arr[..., 3:]
        arr = rgb * a + (1.0 - a)
    elif arr.ndim == 2:
        arr = np.stack([arr] * 3, -1)
    return arr[..., :3]


class EvalDataset:
    """Validation API consumed by ``eval.py``.  Subclasses fill
    ``val_rays``, ``val_rgbs`` (or None), ``white_back`` and, where renders
    are named after source images, ``val_fnames``."""

    white_back: bool = False
    val_rays: List[np.ndarray]
    val_rgbs: Optional[List[np.ndarray]] = None
    val_fnames: Optional[List[str]] = None

    def val_len(self) -> int:
        return len(self.val_rays)

    def val_item(self, idx: int) -> Dict[str, np.ndarray]:
        item = {"rays": self.val_rays[idx]}
        if self.val_rgbs is not None and idx < len(self.val_rgbs):
            item["rgbs"] = self.val_rgbs[idx]
        if self.val_fnames is not None and idx < len(self.val_fnames):
            item["fname"] = self.val_fnames[idx]
        return item


def build_warp_banks(
    ref_image: np.ndarray,
    ref_depth: np.ndarray,
    ref_proj: np.ndarray,
    src_projs: np.ndarray,
    zbuffer: bool,
    device: torch.device = torch.device("cpu"),
) -> Tuple[np.ndarray, np.ndarray]:
    """Warp the reference RGB-D into every pseudo pose, one pose at a time,
    in float32 on ``device``.  Returns (bank_rgb (P, H, W, 3), bank_depth
    (P, H, W)) as numpy."""
    img = torch.as_tensor(ref_image, dtype=torch.float32, device=device)
    dep = torch.as_tensor(ref_depth, dtype=torch.float32, device=device)
    ref_p = torch.as_tensor(ref_proj, dtype=torch.float32, device=device)
    rgbs, depths = [], []
    for src_p in np.asarray(src_projs):
        rgb, depth = forward_warp(img, dep, ref_p, torch.as_tensor(src_p, dtype=torch.float32, device=device),
                                  zbuffer)
        rgbs.append(rgb.cpu().numpy())
        depths.append(depth.cpu().numpy())
    return np.stack(rgbs), np.stack(depths)


def build_proj_index(bank_rgb: np.ndarray, bank_depth: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The warp banks' valid pixels as a flat sampling index: (pose_idx
    (V,), pix_idx (V,), depth (V,)).  Validity is the reference's
    rgb-sum-nonzero hole mask (``blender_rot3d.py:402``)."""
    p, h, w, _ = bank_rgb.shape
    valid = bank_rgb.reshape(p, h * w, 3).sum(-1) != 0
    pose_idx, pix_idx = np.nonzero(valid)
    depth = bank_depth.reshape(p, h * w)[pose_idx, pix_idx]
    return pose_idx.astype(np.int64), pix_idx.astype(np.int64), depth.astype(np.float32)


class SingleImageDataset(EvalDataset):
    """A training dataset of one posed RGB-D image: ``scene`` (the sampler's
    array bundle, on the device it was built for), ``cfg`` (its
    ``SamplerConfig``) and ``length`` (items per epoch), plus the validation
    API of ``EvalDataset``."""

    scene: Dict[str, torch.Tensor]
    cfg: SamplerConfig
    length: int = 1

    def __len__(self) -> int:
        return self.length

    def sample(self, step: int, batch_size: int = 1, generator: Optional[torch.Generator] = None, draws=None):
        """The batch of ``step`` with a leading (batch_size,) axis."""
        return sample_batch(self.scene, step, self.cfg, batch_size, generator, draws)

    def sample_many(self, steps, batch_size: int = 1, generator: Optional[torch.Generator] = None, draws=None):
        """The batches of ``steps`` in one batched call (JAX :97), leaves of
        shape (K, batch_size, ...): slice ``[j]`` is ``sample(steps[j])`` bit
        for bit, and ``generator`` ends where K calls of ``sample`` leave it."""
        return sample_batches_prefetch(self.scene, steps, self.cfg, batch_size, generator, draws)

    @staticmethod
    def _finalize_scene(scene_np: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.ascontiguousarray(v)).to(device) for k, v in scene_np.items()}
