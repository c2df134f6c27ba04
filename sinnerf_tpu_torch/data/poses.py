"""Camera pose math for the datasets and the training sampler.

The port's own copy of ``sinnerf_tpu/data/poses.py`` and
``sinnerf_tpu/data/jnp_poses.py`` (reference
``datasets/llff_ray_patch_1image_proj.py:174-319``,
``blender_ray_patch_1image_rot3d.py:31-100``, ``dtu_proj.py:45-164``): pose
averaging and centering, the spiral and spheric test paths, DTU's look-at
rotations and spiral path, the Blender pseudo-view
banks and the warps' projections of the banks (numpy, float64, named
``*_np`` where a tensor function holds the JAX name), and the rotation,
world-to-camera and projection matrices of the sampler's fresh warp
(tensors).
Conventions: c2w are OpenGL-style (x right, y up, -z forward); the warps'
w2c are OpenCV-style (y down, +z forward).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# OpenGL camera -> OpenCV camera axis flip
_GL_TO_CV = ((1.0, 0.0, 0.0), (0.0, -1.0, 0.0), (0.0, 0.0, -1.0))


def trans_t(t: float) -> np.ndarray:
    m = np.eye(4)
    m[2, 3] = t
    return m


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


def rot_z(th: float) -> np.ndarray:
    c, s = np.cos(th), np.sin(th)
    return np.array(
        [[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], dtype=np.float64
    )


def to_homo(pose: np.ndarray) -> np.ndarray:
    """(3, 4) -> (4, 4) with [0, 0, 0, 1] appended."""
    pose = np.asarray(pose, dtype=np.float64)
    if pose.shape[0] == 4:
        return pose
    return np.concatenate([pose, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)


def invert_pose(pose: np.ndarray) -> np.ndarray:
    """``flatten`` in the reference (``blender_rot3d.py:74-77``): the
    homogeneous inverse, as (3, 4)."""
    return np.linalg.inv(to_homo(pose))[:3, :4]


def rotate_3d_np(c2w: np.ndarray, x_deg: float, y_deg: float, z_deg: float) -> np.ndarray:
    """JAX ``poses.rotate_3d`` (:52): ``rot_phi(x) @ rot_theta(y) @ rot_z(z)
    @ c2w`` in float64, (4, 4)."""
    rot = rot_phi(np.deg2rad(x_deg)) @ rot_theta(np.deg2rad(y_deg)) @ rot_z(np.deg2rad(z_deg))
    return rot @ to_homo(c2w)


def convert_c2w_to_w2c_cv(c2w: np.ndarray) -> np.ndarray:
    """OpenGL c2w -> OpenCV w2c (4, 4) in float64 (JAX :78, reference
    ``blender_rot3d.py:85-100``)."""
    c2w = to_homo(c2w)
    flip = np.array(_GL_TO_CV, dtype=np.float64)
    r_w2c = c2w[:3, :3].T
    t_w2c = -r_w2c @ c2w[:3, 3:]
    out = np.eye(4)
    out[:3, :3] = flip @ r_w2c
    out[:3, 3:] = flip @ t_w2c
    return out


def projection_matrix_np(k: np.ndarray, w2c: np.ndarray) -> np.ndarray:
    """JAX ``poses.projection_matrix`` (:95): P (4, 4) with ``P[:3] = K @
    w2c[:3]`` in float64."""
    p = to_homo(np.asarray(w2c, dtype=np.float64)).copy()
    p[:3, :4] = np.asarray(k, dtype=np.float64) @ p[:3, :4]
    return p


def camera_projection_np(k3: np.ndarray, c2w: np.ndarray) -> np.ndarray:
    """A camera's float64 pixel projection, K @ OpenCV w2c, as the datasets
    build their warp banks."""
    return projection_matrix_np(k3, convert_c2w_to_w2c_cv(c2w))


def rot3d_grid(ref_c2w: np.ndarray, angle: int) -> np.ndarray:
    """The 125-pose pseudo-view bank: x, y, z in {-a, -a/2, 0, a/2, a}
    (JAX :207, reference ``blender_rot3d.py:365-370``).  (125, 3, 4)."""
    step = max(angle // 2, 1)
    grid = range(-angle, angle + 1, step)
    return np.stack([rotate_3d_np(ref_c2w, x, y, z)[:3, :4] for x in grid for y in grid for z in grid], 0)


def rot_z_linspace(ref_c2w: np.ndarray, angle: float, n: int = 60) -> np.ndarray:
    """The Blender ``proj`` bank: rot_z over linspace(-angle, angle, n)
    (JAX :219, reference ``blender_ray_patch_1image_proj.py:355-356``)."""
    ref4 = to_homo(ref_c2w)
    return np.stack([(rot_z(np.deg2rad(a)) @ ref4)[:3, :4] for a in np.linspace(-angle, angle, n)], 0)


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


def look_at_rotation(camera_position: np.ndarray, at=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Batched look-at rotations (JAX :164, reference ``dtu_proj.py:45-72``):
    camera_position (N, 3) -> (N, 3, 3), columns x, y, z; a camera on the
    ``up`` axis takes its x axis from y x z."""
    pos = np.atleast_2d(np.asarray(camera_position, dtype=np.float64))
    at = np.broadcast_to(np.asarray(at, dtype=np.float64), pos.shape)
    up = np.broadcast_to(np.asarray(up, dtype=np.float64), pos.shape)

    def norm_rows(v):
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-5)

    z_axis = norm_rows(pos - at)
    x_axis = norm_rows(np.cross(up, z_axis))
    y_axis = norm_rows(np.cross(z_axis, x_axis))
    degenerate = np.all(np.isclose(x_axis, 0.0, atol=5e-3), axis=1, keepdims=True)
    if degenerate.any():
        x_axis = np.where(degenerate, norm_rows(np.cross(y_axis, z_axis)), x_axis)
    return np.swapaxes(np.stack([x_axis, y_axis, z_axis], axis=1), 1, 2)


def pose_spherical_dtu(radii: np.ndarray, focus_depth: float, n_poses: int = 120,
                       world_center: np.ndarray = np.zeros(3)) -> np.ndarray:
    """The DTU spiral render path, OpenCV-handed (JAX :188, reference
    ``dtu_proj.py:130-164``): (n_poses, 3, 4)."""
    poses = []
    for t in np.linspace(0, 4 * np.pi, n_poses + 1)[:-1]:
        center = np.array([np.cos(t), -np.sin(t), -np.sin(0.5 * t)]) * radii
        z = normalize(center - np.array([0, 0, -focus_depth]))
        y_ = np.array([0.0, 1.0, 0.0])
        x = normalize(np.cross(y_, z))
        y = np.cross(z, x)
        poses.append(np.stack([x, y, z, center + world_center], 1))
    flip = np.array([[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1.0]])
    return np.stack(poses, 0) @ flip


# --------------------------------------------------------------------------
# Pose math for the depth warps, as tensors (JAX ``data/jnp_poses.py`` and
# ``data/poses.py:52-100``): float64 on the host when a dataset builds its
# warp banks, float32 on the device when the sampler warps fresh views.
# Each function takes a leading batch of poses.  Their products are written
# out (``matmul_in_order``), so that a pose's result does not depend on how
# many poses share the call: a batched and a one-off matmul may round apart,
# and one ulp in a projection can move a splat to the next pixel.
# --------------------------------------------------------------------------


def matmul_in_order(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over the last two axes (leading axes broadcast), each entry
    the sum of its products taken left to right, one elementwise operation
    at a time: the same rounding whatever the batch."""
    out = a[..., :, :1] * b[..., :1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k : k + 1] * b[..., k : k + 1, :]
    return out


def _rot(axis: str, angle: torch.Tensor) -> torch.Tensor:
    """(...) angles in radians -> (..., 3, 3) rotations about ``axis``."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    rows = {
        "x": [[o, z, z], [z, c, -s], [z, s, c]],
        "y": [[c, z, -s], [z, o, z], [s, z, c]],
        "z": [[c, -s, z], [s, c, z], [z, z, o]],
    }[axis]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotate_3d(c2w: torch.Tensor, x_deg, y_deg, z_deg) -> torch.Tensor:
    """World-frame Euler rotation of a (3, 4) or (4, 4) pose by degrees
    (``jnp_poses.rotate_3d``, reference ``blender_rot3d.py:80-82``):
    ``rot_x(x) @ rot_y(y) @ rot_z(z) @ c2w``, returned as (..., 3, 4) for
    angles of shape (...)."""
    c2w = torch.as_tensor(c2w)[..., :3, :4]

    def rad(deg):
        return torch.deg2rad(torch.as_tensor(deg, dtype=c2w.dtype, device=c2w.device))

    rot = matmul_in_order(matmul_in_order(_rot("x", rad(x_deg)), _rot("y", rad(y_deg))), _rot("z", rad(z_deg)))
    return matmul_in_order(rot, c2w)


def c2w_to_w2c_cv(c2w: torch.Tensor) -> torch.Tensor:
    """OpenGL c2w (..., 3, 4) or (..., 4, 4) -> OpenCV w2c (..., 4, 4)
    (reference ``blender_rot3d.py:85-100``): ``R' = flip R^T``, ``t' = flip
    (-R^T t)`` with flip negating the camera's y and z axes."""
    c2w = torch.as_tensor(c2w)
    r_w2c = c2w[..., :3, :3].transpose(-1, -2)
    top = torch.cat([r_w2c, -matmul_in_order(r_w2c, c2w[..., :3, 3:])], dim=-1)
    top = torch.cat([top[..., :1, :], -top[..., 1:, :]], dim=-2)
    bottom = torch.zeros_like(top[..., :1, :])  # [0, 0, 0, 1], made on the device: no copy from the host
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def projection_matrix(k3: torch.Tensor, w2c4: torch.Tensor) -> torch.Tensor:
    """The (..., 4, 4) pixel projection with ``P[:3] = K @ w2c[:3]``
    (reference ``dtu_proj.py:351-352``)."""
    k3 = torch.as_tensor(k3, dtype=w2c4.dtype, device=w2c4.device)
    return torch.cat([matmul_in_order(k3, w2c4[..., :3, :4]), w2c4[..., 3:4, :]], dim=-2)
