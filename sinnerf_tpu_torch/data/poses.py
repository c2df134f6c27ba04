"""Camera pose math for the LLFF eval loader (host-side numpy).

The port's own copy of the pieces of ``sinnerf_tpu/data/poses.py`` that
``LLFFEval`` needs (reference ``datasets/llff_ray_patch_1image_proj.py:
174-319``): pose averaging and centering, and the spiral and spheric test
paths.  Conventions: c2w are OpenGL-style (x right, y up, -z forward).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def rot_phi(phi: float) -> np.ndarray:
    c, s = np.cos(phi), np.sin(phi)
    return np.array(
        [[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], dtype=np.float64
    )


def rot_theta(th: float) -> np.ndarray:
    c, s = np.cos(th), np.sin(th)
    return np.array(
        [[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], dtype=np.float64
    )


def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def average_poses(poses: np.ndarray) -> np.ndarray:
    """(N, 3, 4) -> (3, 4) average pose (llff_proj.py:174-210)."""
    center = poses[..., 3].mean(0)
    z = normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)


def center_poses(poses: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Recenter poses about their average (llff_proj.py:213-241).
    Returns (poses_centered (N, 3, 4), inverse-average (4, 4))."""
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = average_poses(poses)
    last_row = np.tile(np.array([0, 0, 0, 1.0]), (len(poses), 1, 1))
    poses_homo = np.concatenate([poses, last_row], 1)
    inv_avg = np.linalg.inv(pose_avg_homo)
    return (inv_avg @ poses_homo)[:, :3], inv_avg


def create_spiral_poses(
    radii: np.ndarray, focus_depth: float, n_poses: int = 120
) -> np.ndarray:
    """LLFF spiral render path (llff_proj.py:244-276)."""
    poses = []
    for t in np.linspace(0, 4 * np.pi, n_poses + 1)[:-1]:
        center = np.array([np.cos(t), -np.sin(t), -np.sin(0.5 * t)]) * radii
        z = normalize(center - np.array([0, 0, -focus_depth]))
        y_ = np.array([0.0, 1.0, 0.0])
        x = normalize(np.cross(y_, z))
        y = np.cross(z, x)
        poses.append(np.stack([x, y, z, center], 1))
    return np.stack(poses, 0)


def create_spheric_poses(radius: float, n_poses: int = 120) -> np.ndarray:
    """Circular render path around z (llff_proj.py:279-319)."""

    def spheric_pose(theta: float, phi: float, radius: float) -> np.ndarray:
        t = np.eye(4)
        t[1, 3] = -0.9 * radius
        t[2, 3] = radius
        c2w = rot_theta(theta) @ rot_phi(phi) @ t
        flip = np.array(
            [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1.0]]
        )
        return (flip @ c2w)[:3]

    return np.stack(
        [
            spheric_pose(th, -np.pi / 5, radius)
            for th in np.linspace(0, 2 * np.pi, n_poses + 1)[:-1]
        ],
        0,
    )
