"""Depth-map visualization (jet colormap), host-side.

The port's own copy of ``sinnerf_tpu/utils/visualization.py`` (reference
``utils/visualization.py:7-19``).
"""

from __future__ import annotations

import numpy as np


def visualize_depth(depth) -> np.ndarray:
    """depth: (H, W) array-like -> (3, H, W) float32 jet-colored image."""
    import cv2

    x = np.nan_to_num(np.asarray(depth, dtype=np.float32))
    mi, ma = np.min(x), np.max(x)
    x = (x - mi) / (ma - mi + 1e-8)
    x8 = (255 * x).astype(np.uint8)
    colored = cv2.applyColorMap(x8, cv2.COLORMAP_JET)  # BGR uint8
    rgb = colored[..., ::-1].astype(np.float32) / 255.0
    return np.transpose(rgb, (2, 0, 1))
