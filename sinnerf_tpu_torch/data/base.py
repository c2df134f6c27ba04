"""Host-side helpers and the validation API shared by the eval datasets.

Counterpart of ``sinnerf_tpu/data/base.py:68-152``: ray packing, image
loading and the ``val_len``/``val_item`` API.  The training sampler is not
part of this port yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def pack_rays_np(
    directions: np.ndarray, c2w: np.ndarray, near: float, far: float
) -> np.ndarray:
    """Host-side [o, d, near, far] packing; directions (..., 3), c2w (3, 4)."""
    d = directions.reshape(-1, 3) @ np.asarray(c2w)[:3, :3].T
    o = np.broadcast_to(np.asarray(c2w)[:3, 3], d.shape)
    nf = np.broadcast_to(np.array([near, far], np.float32), (d.shape[0], 2))
    return np.concatenate([o, d, nf], axis=-1).astype(np.float32)


def load_image(path: str, img_wh: Tuple[int, int]) -> np.ndarray:
    """Load and Lanczos-resize an image to (H, W, 3) float32 in [0, 1]."""
    from PIL import Image

    img = Image.open(path).resize(img_wh, Image.LANCZOS)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
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
