"""The rays of a scene's views, worked out from its raw camera file.

LLFF (``poses_bounds.npy``, the ``llff_ray_patch_1image_proj`` and ``llff``
loaders' ``test_train`` split): each row holds a 3x5 [R | t | hwf] pose in
"down right back" axes and the view's near and far bounds.  The poses are
turned to "right up back", centred on their average pose and scaled so that
the nearest bound is 4/3; near is 0.9x the nearest bound and far the
farthest, both scaled.  A pixel (i, j) looks along ``((i - W/2) / f, -(j -
H/2) / f, -1)`` in the camera frame (no half-pixel offset), ``f`` the focal
length scaled to the image width.  Rays are ``[o, d, near, far]``, ``d``
not normalised.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def llff_views(root: str, img_wh: Tuple[int, int]) -> List[np.ndarray]:
    """(H*W, 8) float32 rays of every view in the file's order."""
    rows = np.load(f"{root}/poses_bounds.npy").astype(np.float64)
    poses = rows[:, :15].reshape(-1, 3, 5)
    bounds = rows[:, -2:]
    h0, w0, f0 = poses[0, :, 4]
    poses = np.concatenate([poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], -1)
    center = poses[..., 3].mean(0)
    z = _normalize(poses[..., 2].mean(0))
    x = _normalize(np.cross(poses[..., 1].mean(0), z))
    avg = np.eye(4)
    avg[:3] = np.stack([x, np.cross(z, x), z, center], 1)
    homo = np.concatenate([poses, np.tile([[[0.0, 0.0, 0.0, 1.0]]], (len(poses), 1, 1))], 1)
    poses = (np.linalg.inv(avg) @ homo)[:, :3]
    scale = bounds.min() * 0.75
    poses[..., 3] /= scale
    near, far = bounds.min() * 0.9 / scale, (bounds / scale).max()
    w, h = img_wh
    focal = f0 * w / w0
    i, j = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64), indexing="xy")
    dirs = np.stack([(i - w / 2) / focal, -(j - h / 2) / focal, -np.ones_like(i)], -1).reshape(-1, 3)
    views = []
    for pose in poses:
        d = dirs @ pose[:, :3].T
        o = np.broadcast_to(pose[:, 3], d.shape)
        nf = np.broadcast_to([near, far], (d.shape[0], 2))
        views.append(np.concatenate([o, d, nf], -1).astype(np.float32))
    return views
