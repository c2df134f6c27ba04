"""Camera pose math for the LLFF loaders and the training sampler.

The port's own copy of the pieces of ``sinnerf_tpu/data/poses.py`` and
``sinnerf_tpu/data/jnp_poses.py`` that the LLFF datasets and the sampler
need (reference ``datasets/llff_ray_patch_1image_proj.py:174-319``,
``blender_ray_patch_1image_rot3d.py:80-100``): pose averaging and
centering, the spiral and spheric test paths (numpy), and the rotation,
world-to-camera and projection matrices of the depth warps (tensors).
Conventions: c2w are OpenGL-style (x right, y up, -z forward); the warps'
w2c are OpenCV-style (y down, +z forward).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


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


# --------------------------------------------------------------------------
# Pose math for the depth warps, as tensors (JAX ``data/jnp_poses.py`` and
# ``data/poses.py:52-100``): float64 on the host when a dataset builds its
# warp banks, float32 on the device when the sampler warps a fresh view.
# --------------------------------------------------------------------------


def _rot(axis: str, angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    rows = {
        "x": [[o, z, z], [z, c, -s], [z, s, c]],
        "y": [[c, z, -s], [z, o, z], [s, z, c]],
        "z": [[c, -s, z], [s, c, z], [z, z, o]],
    }[axis]
    return torch.stack([torch.stack(r) for r in rows])


def rotate_3d(c2w: torch.Tensor, x_deg, y_deg, z_deg) -> torch.Tensor:
    """World-frame Euler rotation of a (3, 4) or (4, 4) pose by degrees
    (``jnp_poses.rotate_3d``, reference ``blender_rot3d.py:80-82``):
    ``rot_x(x) @ rot_y(y) @ rot_z(z) @ c2w``, returned as (3, 4)."""
    c2w = torch.as_tensor(c2w)[:3, :4]

    def rad(deg):
        return torch.deg2rad(torch.as_tensor(deg, dtype=c2w.dtype, device=c2w.device))

    rot = _rot("x", rad(x_deg)) @ _rot("y", rad(y_deg)) @ _rot("z", rad(z_deg))
    return torch.cat([rot @ c2w[:, :3], rot @ c2w[:, 3:]], dim=1)


_GL_TO_CV = ((1.0, 0.0, 0.0), (0.0, -1.0, 0.0), (0.0, 0.0, -1.0))


def c2w_to_w2c_cv(c2w: torch.Tensor) -> torch.Tensor:
    """OpenGL c2w (3, 4) or (4, 4) -> OpenCV w2c (4, 4) (reference
    ``blender_rot3d.py:85-100``): ``R' = flip R^T``, ``t' = flip (-R^T t)``
    with flip negating the camera's y and z axes."""
    c2w = torch.as_tensor(c2w)
    flip = torch.tensor(_GL_TO_CV, dtype=c2w.dtype, device=c2w.device)
    r_w2c = c2w[:3, :3].T
    t_w2c = -r_w2c @ c2w[:3, 3:]
    top = torch.cat([flip @ r_w2c, flip @ t_w2c], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=c2w.dtype, device=c2w.device)
    return torch.cat([top, bottom], dim=0)


def projection_matrix(k3: torch.Tensor, w2c4: torch.Tensor) -> torch.Tensor:
    """The (4, 4) pixel projection with ``P[:3] = K @ w2c[:3]``
    (reference ``dtu_proj.py:351-352``)."""
    k3 = torch.as_tensor(k3, dtype=w2c4.dtype, device=w2c4.device)
    return torch.cat([k3 @ w2c4[:3, :4], w2c4[3:4, :]], dim=0)
