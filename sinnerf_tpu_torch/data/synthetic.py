"""Procedural LLFF scene written in the on-disk format.

The port's own copy of ``sinnerf_tpu/data/synthetic.py::make_llff_scene``
(:86), so the port's tests and ``chip_smoke.py`` make scenes without JAX.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def _save_png(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8)).save(path)


def make_llff_scene(
    root: str, img_wh: Tuple[int, int] = (64, 48), n_images: int = 5
) -> str:
    """LLFF layout: poses_bounds.npy + images/*.JPG + depth_nerf/."""
    w, h = img_wh
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth_nerf"), exist_ok=True)

    focal = 1.2 * w
    rows = []
    rng = np.random.default_rng(0)
    for i in range(n_images):
        # forward-facing cameras, small lateral offsets; middle image closest
        # to center so val_idx lands in the interior
        t = np.array(
            [0.4 * (i - n_images // 2), 0.05 * rng.standard_normal(), 10.0]
        )
        c2w_rub = np.concatenate([np.eye(3), t[:, None]], axis=1)  # right-up-back
        # stored as "down right back" (inverse of the loader's axis fix)
        c2w_drb = np.concatenate(
            [-c2w_rub[:, 1:2], c2w_rub[:, 0:1], c2w_rub[:, 2:4]], axis=1
        )
        hwf = np.array([h, w, focal]).reshape(3, 1)
        rows.append(
            np.concatenate(
                [np.concatenate([c2w_drb, hwf], axis=1).reshape(-1), [8.0, 14.0]]
            )
        )
        img = np.zeros((h, w, 3), np.float32)
        img[..., 0] = np.linspace(0, 1, w)[None, :]
        img[..., 1] = np.linspace(0, 1, h)[:, None]
        img[..., 2] = 0.3 + 0.1 * i
        _save_png(os.path.join(root, "images", f"IMG_{i:04d}.JPG"), img)
        depth = 10.0 + 2.0 * np.linspace(0, 1, w)[None, :] * np.ones((h, 1))
        np.save(
            os.path.join(root, "depth_nerf", f"IMG_{i:04d}.npy"),
            depth.astype(np.float32),
        )
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows))
    return root
