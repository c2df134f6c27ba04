"""Procedural scenes written in each dataset's on-disk format.

The port's own copy of ``sinnerf_tpu/data/synthetic.py``, so the port's
tests, ``chip_smoke.py`` and the convergence demo make scenes without JAX:
the plain writers (a coloured disk or gradient at known depth, per-view
images that are not consistent across views; for loader and warp tests)
and the rich ones (an analytic scene ray-traced from every final pose with
the loaders' own parsers and ray directions, multi-view consistent; for
convergence runs).  They write the JAX writers' files byte for byte
(``tests/test_torch_datasets.py``).
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from sinnerf_tpu_torch.data import poses as pose_np
from sinnerf_tpu_torch.data.depth_io import save_pfm


def _save_png(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8)).save(path)


def _disk_image(h: int, w: int, rgba: bool) -> Tuple[np.ndarray, np.ndarray]:
    """A colored disk on transparent/white background + its depth map."""
    yy, xx = np.mgrid[0:h, 0:w]
    cx, cy, r = w / 2, h / 2, min(h, w) / 3
    dist = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    inside = dist < r
    img = np.zeros((h, w, 4 if rgba else 3), np.float32)
    img[..., 0] = np.where(inside, 0.8, 1.0)
    img[..., 1] = np.where(inside, 0.3 + 0.4 * xx / w, 1.0)
    img[..., 2] = np.where(inside, 0.2 + 0.5 * yy / h, 1.0)
    if rgba:
        img[..., 3] = inside.astype(np.float32)
    # bulging depth: nearer at the disk center
    depth = np.where(inside, 4.0 - 0.5 * np.cos(dist / r * np.pi / 2), 0.0)
    return img, depth.astype(np.float32)


def _blender_pose(radius: float, theta_deg: float, phi_deg: float) -> np.ndarray:
    """OpenGL c2w looking at the origin from spherical coordinates."""
    th, ph = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    cam = pose_np.rot_theta(th) @ pose_np.rot_phi(ph) @ pose_np.trans_t(radius)
    return cam


def make_blender_scene(
    root: str, img_wh: Tuple[int, int] = (64, 64), n_frames: int = 3
) -> str:
    """NeRF-synthetic layout: transforms_train/mytest.json + pngs + depth_nerf."""
    h, w = img_wh[1], img_wh[0]
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth_nerf"), exist_ok=True)

    frames = []
    for i in range(n_frames):
        c2w = _blender_pose(4.0, 10.0 * i, -30.0)
        img, depth = _disk_image(h, w, rgba=True)
        name = f"train/r_{i}"
        _save_png(os.path.join(root, name + ".png"), img)
        np.save(
            os.path.join(root, "depth_nerf", f"r_{i}.npy"), depth
        )
        frames.append(
            {"file_path": f"./{name}", "transform_matrix": c2w.tolist()}
        )
    meta = {"camera_angle_x": 0.6911112070083618, "frames": frames}
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump(meta, f)
    # mytest split: 60 frames sliced [30-angle : 30+angle] by the loader
    mytest_frames = [
        {
            "file_path": frames[0]["file_path"],
            "transform_matrix": _blender_pose(4.0, 3.0 * (i - 30), -30.0).tolist(),
        }
        for i in range(60)
    ]
    with open(os.path.join(root, "transforms_mytest.json"), "w") as f:
        json.dump({"camera_angle_x": 0.6911112070083618, "frames": mytest_frames}, f)
    return root


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
        # to center so val_idx lands in the interior (ref = val-1 >= 0)
        t = np.array(
            [0.4 * (i - n_images // 2), 0.05 * rng.standard_normal(), 10.0]
        )
        c2w_rub = np.concatenate([np.eye(3), t[:, None]], axis=1)  # right-up-back
        # store as "down right back" (inverse of the loader's axis fix)
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


def make_dtu_scene(
    root: str,
    img_wh: Tuple[int, int] = (64, 64),
    scan: int = 4,
    n_src: int = 3,
) -> str:
    """DTU layout: Cameras/{train/*_cam.txt,pair.txt} + Rectified pngs +
    MVSNet_pytorch_outputs pfms (1/4-res, the loader upsamples 4x)."""
    w, h = img_wh
    cam_dir = os.path.join(root, "Cameras", "train")
    rect_dir = os.path.join(root, f"Rectified/scan{scan}_train")
    mvs_dir = os.path.join(root, f"MVSNet_pytorch_outputs/scan{scan}/depth_est")
    for d in (cam_dir, rect_dir, mvs_dir):
        os.makedirs(d, exist_ok=True)

    f4 = 0.3 * w  # cam files hold 1/4-res intrinsics; loader multiplies by 4
    view_ids = [2] + [10 + i for i in range(n_src)]
    for j, vid in enumerate(view_ids):
        # cameras on a small arc looking at the origin from +z
        angle = 0.06 * j
        rot = pose_np.rot_theta(angle)[:3, :3]
        center = rot @ np.array([0.0, 0.0, -600.0])
        z = -center / np.linalg.norm(center)
        up = np.array([0.0, -1.0, 0.0])
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([x, y, z], axis=1)
        c2w[:3, 3] = center
        w2c = np.linalg.inv(c2w)
        lines = ["extrinsic"]
        for r in range(4):
            lines.append(" ".join(f"{v:.8f}" for v in w2c[r]))
        lines += [
            "",
            "intrinsic",
            f"{f4:.4f} 0 {w / 8:.4f}",
            f"0 {f4:.4f} {h / 8:.4f}",
            "0 0 1",
            "",
            "425.0 2.5",
        ]
        with open(os.path.join(cam_dir, f"{vid:08d}_cam.txt"), "w") as f:
            f.write("\n".join(lines))

        img = np.zeros((h, w, 3), np.float32)
        img[..., 0] = 0.2 + 0.6 * np.linspace(0, 1, w)[None, :]
        img[..., 1] = 0.2 + 0.6 * np.linspace(0, 1, h)[:, None]
        img[..., 2] = 0.5
        _save_png(os.path.join(rect_dir, f"rect_{vid + 1:03d}_3_r5000.png"), img)
        depth4 = np.full((h // 4, w // 4), 600.0, np.float32)
        save_pfm(
            os.path.join(mvs_dir, f"rect_{vid + 1:03d}_3_r5000.pfm"), depth4
        )

    pair_lines = [str(len(view_ids))]
    for vid in view_ids:
        pair_lines.append(str(vid))
        others = [v for v in view_ids if v != vid]
        pair_lines.append(
            f"{len(others)} " + " ".join(f"{v} 100.0" for v in others)
        )
    with open(os.path.join(root, "Cameras", "pair.txt"), "w") as f:
        f.write("\n".join(pair_lines))
    return root


# --------------------------------------------------------------------------
# "Rich" multi-view-consistent scenes for convergence soaks.
#
# The default generators above produce per-image gradients that are NOT
# consistent across views (fine for loader/warp unit tests, useless for
# measuring converged val PSNR: the val image simply isn't explainable by
# any radiance field).  The rich variants write the camera files first,
# re-parse them with the dataset's OWN parser, then ray-trace an analytic
# scene (lambertian textured spheres + a checkered back plane) from the
# exact final poses with the exact final ray directions
# (core/rays.get_ray_directions*).  Images, depth maps, and poses are then
# multi-view consistent by construction, in each loader's own depth
# convention (t along the unnormalized ray == z-depth, the same quantity
# NeRF's depth head integrates), so the published recipes
# (the reference README, lines 59-86) can genuinely converge on them.
# --------------------------------------------------------------------------

_LIGHT = np.array([0.45, 0.75, -0.49])
_LIGHT = _LIGHT / np.linalg.norm(_LIGHT)


def _make_objects(near_d, far_d, origin, forward, up, right, rng):
    """Spheres + back plane placed inside the shared viewing frustum.

    Distances are in the dataset's final "t" metric (z-depth along the view
    axis).  Returns a dict consumed by :func:`_trace`."""
    dmid = 0.5 * (near_d + far_d)
    lat = 0.30 * dmid  # lateral spread (stay inside every frustum)
    dep = 0.22 * (far_d - near_d)
    cols = np.array(
        [
            [0.85, 0.25, 0.20],
            [0.20, 0.70, 0.30],
            [0.25, 0.35, 0.85],
            [0.85, 0.75, 0.20],
            [0.70, 0.25, 0.75],
            [0.25, 0.75, 0.75],
            [0.90, 0.55, 0.25],
        ]
    )
    spheres = []
    for k in range(7):
        off = rng.uniform(-1, 1, 3) * np.array([lat, 0.6 * lat, dep])
        center = (
            origin
            + forward * (dmid + off[2])
            + right * off[0]
            + up * off[1]
        )
        radius = dmid * rng.uniform(0.06, 0.13)
        freq = rng.uniform(4.0, 9.0) / radius
        spheres.append((center, radius, cols[k], freq))
    # background: the interior of a large textured shell centered on the
    # camera cluster — unlike a flat plane, the z-depth of every shell hit is
    # bounded by shell_r + camera spread, so it stays inside [near, far] even
    # for oblique corner rays
    return {
        "spheres": spheres,
        "shell_c": origin,
        "shell_r": 0.85 * far_d,
    }


def _trace(rays_o, rays_d, objs):
    """Ray-trace the analytic scene.  rays_o/rays_d: (N, 3) world-frame,
    rays_d UNNORMALIZED with unit component along the camera view axis so the
    returned t is z-depth (the loaders' and NeRF's shared convention).
    Returns (rgb (N, 3) in [0, 1], t (N,))."""
    n = rays_d.shape[0]
    rays_o = np.broadcast_to(rays_o, rays_d.shape)
    tbest = np.full(n, np.inf)
    rgb = np.zeros((n, 3), np.float64)

    for center, radius, col, freq in objs["spheres"]:
        oc = rays_o - center
        a = (rays_d * rays_d).sum(-1)
        b = (rays_d * oc).sum(-1)
        c = (oc * oc).sum(-1) - radius * radius
        disc = b * b - a * c
        valid = disc > 0
        t = (-b - np.sqrt(np.maximum(disc, 0.0))) / a
        closer = valid & (t > 1e-3) & (t < tbest)
        if closer.any():
            p = rays_o[closer] + t[closer, None] * rays_d[closer]
            nrm = (p - center) / radius
            lam = 0.35 + 0.65 * np.clip(nrm @ _LIGHT, 0, 1)
            tex = 0.62 + 0.38 * (
                np.sin(freq * p[:, 0])
                * np.sin(freq * p[:, 1])
                * np.sin(freq * p[:, 2])
            )
            rgb[closer] = col[None, :] * (lam * tex)[:, None]
            tbest[closer] = t[closer]

    # checkered shell interior (catches every remaining ray: the cameras sit
    # inside the shell, so no pixel is left black => the warp validity mask
    # (rgb-sum != 0, base.py build_proj_index) stays meaningful).  Rays start
    # inside => take the FAR quadratic root (the exit point).  Shell-less
    # scenes (blender: transparent background, alpha from t > 0) skip it and
    # report misses as rgb 0 / t 0.
    if objs.get("shell_r") is None:
        left = ~np.isfinite(tbest)
        rgb[left] = 0.0
        tbest[left] = 0.0
        return np.clip(rgb, 0.0, 1.0).astype(np.float32), tbest.astype(
            np.float32
        )
    sc, sr = objs["shell_c"], objs["shell_r"]
    oc = rays_o - sc
    a = (rays_d * rays_d).sum(-1)
    b = (rays_d * oc).sum(-1)
    c = (oc * oc).sum(-1) - sr * sr
    disc = np.maximum(b * b - a * c, 0.0)
    tp = (-b + np.sqrt(disc)) / a
    closer = (tp > 1e-3) & (tp < tbest)
    if closer.any():
        p = rays_o[closer] + tp[closer, None] * rays_d[closer]
        rel = (p - sc) / sr
        lon = np.arctan2(rel[:, 2], rel[:, 0])
        lat = np.arcsin(np.clip(rel[:, 1], -1, 1))
        s = 0.22  # checker angular size (radians)
        check = ((np.floor(lon / s) + np.floor(lat / s)) % 2).astype(bool)
        lam = 0.35 + 0.65 * np.clip((-rel) @ _LIGHT, 0, 1)
        shade = 0.10 * np.sin(3.1 * lon) + 0.10 * np.cos(2.3 * lat)
        base = np.where(check[:, None], 0.70, 0.35) + shade[:, None]
        tint = np.array([[0.85, 0.92, 1.0]])
        rgb[closer] = np.clip(base * tint * lam[:, None], 0.05, 1.0)
        tbest[closer] = tp[closer]

    # rays that somehow miss everything (cameras outside the shell would be
    # a generator bug): dim gray at the shell radius
    left = ~np.isfinite(tbest)
    if left.any():
        rgb[left] = 0.3
        tbest[left] = sr
    return np.clip(rgb, 0.0, 1.0).astype(np.float32), tbest.astype(np.float32)


def make_llff_scene_rich(
    root: str,
    img_wh: Tuple[int, int] = (504, 378),
    n_images: int = 10,
    seed: int = 0,
) -> str:
    """Multi-view-consistent LLFF forward-facing capture.

    Writes poses_bounds.npy (grid of laterally-offset forward-facing
    cameras), re-parses it with ``llff._read_poses_bounds`` (centering +
    scale), then traces the shared scene from every FINAL pose, saving
    images/*.png and depth_nerf/*.npy in the final scaled frame — the frame
    the reference's own NeRF-generated depth maps live in."""
    from sinnerf_tpu_torch.core.rays import get_ray_directions
    from sinnerf_tpu_torch.data.llff import _read_poses_bounds

    w, h = img_wh
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth_nerf"), exist_ok=True)
    focal = 1.1 * w
    rng = np.random.default_rng(seed)

    rows = []
    for i in range(n_images):
        # grid of lateral offsets, like a handheld forward-facing capture
        gx = (i % 5) - 2.0
        gy = (i // 5) - 0.5 * ((n_images - 1) // 5)
        t = np.array(
            [0.55 * gx, 0.40 * gy, 10.0 + 0.15 * rng.standard_normal()]
        )
        c2w_rub = np.concatenate([np.eye(3), t[:, None]], axis=1)
        c2w_drb = np.concatenate(
            [-c2w_rub[:, 1:2], c2w_rub[:, 0:1], c2w_rub[:, 2:4]], axis=1
        )
        hwf = np.array([h, w, focal]).reshape(3, 1)
        rows.append(
            np.concatenate(
                [np.concatenate([c2w_drb, hwf], axis=1).reshape(-1), [7.0, 16.0]]
            )
        )
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows))

    poses, _, (h0, w0, f0), near, far, _, _, _ = _read_poses_bounds(root)
    focal_final = f0 * w / w0
    dirs = get_ray_directions(h, w, focal_final).numpy().reshape(-1, 3)

    center = poses[..., 3].mean(0)
    fwd = -poses[..., 2].mean(0)
    fwd /= np.linalg.norm(fwd)
    up = poses[..., 1].mean(0)
    up /= np.linalg.norm(up)
    right = np.cross(fwd, up)
    objs = _make_objects(near, far, center, fwd, up, right, rng)

    for i, pose in enumerate(poses):
        o = np.broadcast_to(pose[:3, 3], dirs.shape)
        d = dirs @ pose[:3, :3].T
        rgb, t = _trace(o, d, objs)
        _save_png(
            os.path.join(root, "images", f"IMG_{i:04d}.png"),
            rgb.reshape(h, w, 3),
        )
        np.save(
            os.path.join(root, "depth_nerf", f"IMG_{i:04d}.npy"),
            t.reshape(h, w),
        )
    return root


def make_dtu_scene_rich(
    root: str,
    img_wh: Tuple[int, int] = (640, 512),
    scan: int = 4,
    n_src: int = 8,
    seed: int = 0,
) -> str:
    """Multi-view-consistent DTU scan: cameras on an arc at ~600 raw units
    looking at the origin, traced in the RAW frame (the loader scales by
    1/200 afterwards).  PFM depth is written at 1/4 resolution in raw units,
    matching MVSNet's outputs (the loader upsamples 4x and scales)."""
    import cv2

    from sinnerf_tpu_torch.core.rays import get_ray_directions_pz

    w, h = img_wh
    cam_dir = os.path.join(root, "Cameras", "train")
    rect_dir = os.path.join(root, f"Rectified/scan{scan}_train")
    mvs_dir = os.path.join(root, f"MVSNet_pytorch_outputs/scan{scan}/depth_est")
    for d in (cam_dir, rect_dir, mvs_dir):
        os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)

    f4 = 0.28 * w  # 1/4-res focal; loader multiplies by 4
    k_full = np.array(
        [[4 * f4, 0, w / 2], [0, 4 * f4, h / 2], [0, 0, 1.0]]
    )
    view_ids = [2] + [10 + i for i in range(n_src)]
    cams = {}
    for j, vid in enumerate(view_ids):
        yaw = 0.24 * ((j - len(view_ids) / 2) / max(1, len(view_ids) - 1)) * 2
        pitch = 0.10 * ((j % 3) - 1)
        rot = (
            pose_np.rot_phi(pitch)[:3, :3] @ pose_np.rot_theta(yaw)[:3, :3]
        )
        center = rot @ np.array([0.0, 0.0, -600.0])
        z = -center / np.linalg.norm(center)  # +z convention: toward origin
        up_w = np.array([0.0, -1.0, 0.0])
        x = np.cross(up_w, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([x, y, z], axis=1)
        c2w[:3, 3] = center
        w2c = np.linalg.inv(c2w)
        cams[vid] = c2w
        lines = ["extrinsic"]
        for r in range(4):
            lines.append(" ".join(f"{v:.8f}" for v in w2c[r]))
        lines += [
            "",
            "intrinsic",
            f"{f4:.4f} 0 {w / 8:.4f}",
            f"0 {f4:.4f} {h / 8:.4f}",
            "0 0 1",
            "",
            "425.0 2.5",
        ]
        with open(os.path.join(cam_dir, f"{vid:08d}_cam.txt"), "w") as f:
            f.write("\n".join(lines))

    # scene in RAW units: near 425, far 425+2.5*192=905, cameras at 600
    fwd_mean = np.mean(
        [cams[v][:3, 2] for v in view_ids], axis=0
    )
    fwd_mean /= np.linalg.norm(fwd_mean)
    origin_mean = np.mean([cams[v][:3, 3] for v in view_ids], axis=0)
    up_mean = -np.mean([cams[v][:3, 1] for v in view_ids], axis=0)
    up_mean /= np.linalg.norm(up_mean)
    right_mean = np.cross(fwd_mean, up_mean)
    objs = _make_objects(
        425.0, 905.0, origin_mean, fwd_mean, up_mean, right_mean, rng
    )

    dirs = get_ray_directions_pz(h, w, k_full).numpy().reshape(-1, 3)
    for vid in view_ids:
        c2w = cams[vid]
        o = np.broadcast_to(c2w[:3, 3], dirs.shape)
        d = dirs @ c2w[:3, :3].T
        rgb, t = _trace(o, d, objs)
        _save_png(
            os.path.join(rect_dir, f"rect_{vid + 1:03d}_3_r5000.png"),
            rgb.reshape(h, w, 3),
        )
        depth4 = cv2.resize(
            t.reshape(h, w),
            (w // 4, h // 4),
            interpolation=cv2.INTER_AREA,
        )
        save_pfm(
            os.path.join(mvs_dir, f"rect_{vid + 1:03d}_3_r5000.pfm"), depth4
        )

    pair_lines = [str(len(view_ids))]
    for vid in view_ids:
        pair_lines.append(str(vid))
        others = [v for v in view_ids if v != vid]
        pair_lines.append(
            f"{len(others)} " + " ".join(f"{v} 100.0" for v in others)
        )
    with open(os.path.join(root, "Cameras", "pair.txt"), "w") as f:
        f.write("\n".join(pair_lines))
    return root


def make_blender_scene_rich(
    root: str,
    img_wh: Tuple[int, int] = (400, 400),
    n_train: int = 21,
    seed: int = 0,
) -> str:
    """Multi-view-consistent NeRF-synthetic capture (the lego-recipe stand-in).

    A cluster of textured spheres around the world origin rendered from the
    standard blender rig (radius-4 sphere, phi -30): RGBA train frames (alpha
    from ray hits — background transparent, blended to white by the loader,
    ``blender_rot3d.py:291``) + z-depth ``depth_nerf`` npys (0 at background),
    and a TRUE ``transforms_mytest.json`` split — 60 frames at theta
    3*(i-30) rendered for real, so val PSNR measures novel-view quality
    against consistent ground truth (the loader's my_testset slice,
    ``blender_rot3d.py:169-197``).  Train frame i sits at theta 10*(i-(n-1)),
    putting the default lego ref_idx (20, REF_IDX table) at theta 0 == the
    mytest center."""
    from sinnerf_tpu_torch.core.rays import get_ray_directions

    w, h = img_wh
    assert w == h, "blender scenes are square"
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth_nerf"), exist_ok=True)
    rng = np.random.default_rng(seed)

    camera_angle_x = 0.6911112070083618
    focal = 0.5 * w / np.tan(0.5 * camera_angle_x)
    dirs = get_ray_directions(h, w, focal).numpy().reshape(-1, 3)

    # sphere cluster inside |c| ~ 1.1 => z-depth in ~[2.3, 5.7] from the
    # radius-4 rig, safely inside the blender NEAR/FAR = [2, 6]
    cols = np.array(
        [
            [0.85, 0.25, 0.20],
            [0.20, 0.70, 0.30],
            [0.25, 0.35, 0.85],
            [0.85, 0.75, 0.20],
            [0.70, 0.25, 0.75],
            [0.25, 0.75, 0.75],
            [0.90, 0.55, 0.25],
        ]
    )
    spheres = []
    for k in range(7):
        center = rng.uniform(-1, 1, 3) * np.array([0.8, 0.6, 0.8])
        radius = rng.uniform(0.28, 0.5)
        # Texture frequency is the knob that decides whether val PSNR can
        # measure anything: at 4-9/radius the sin^3 period is ~25-100 px from
        # the rig, so the ~5 px parallax of a 3-degree orbit fully
        # decorrelates the spheres — GT itself scores 18.2 dB against GT 3
        # degrees away, and no single-image model can beat the GT's own
        # decorrelation floor (measured on the first lego-rich soak: 24 dB at
        # the ref pose collapsing to 13 dB at +-3).  1.0-2.5/radius keeps the
        # period at ~100-430 px: correct geometry re-renders the texture
        # within a fraction of a period, so novel-view PSNR rewards geometry
        # instead of punishing sub-pixel misalignment.
        freq = rng.uniform(1.0, 2.5) / radius
        spheres.append((center, radius, cols[k], freq))
    objs = {"spheres": spheres, "shell_c": None, "shell_r": None}

    def render(c2w):
        o = np.broadcast_to(c2w[:3, 3], dirs.shape)
        d = dirs @ c2w[:3, :3].T
        rgb, t = _trace(o, d, objs)
        rgba = np.concatenate(
            [rgb, (t > 0).astype(np.float32)[:, None]], axis=-1
        )
        return rgba.reshape(h, w, 4), t.reshape(h, w)

    frames = []
    for i in range(n_train):
        c2w = _blender_pose(4.0, 10.0 * (i - (n_train - 1)), -30.0)
        rgba, depth = render(c2w)
        name = f"train/r_{i}"
        _save_png(os.path.join(root, name + ".png"), rgba)
        np.save(os.path.join(root, "depth_nerf", f"r_{i}.npy"), depth)
        frames.append(
            {"file_path": f"./{name}", "transform_matrix": c2w.tolist()}
        )
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, f)

    mytest_frames = []
    for i in range(60):
        c2w = _blender_pose(4.0, 3.0 * (i - 30), -30.0)
        rgba, _ = render(c2w)
        name = f"train/mytest_{i}"
        _save_png(os.path.join(root, name + ".png"), rgba)
        mytest_frames.append(
            {"file_path": f"./{name}", "transform_matrix": c2w.tolist()}
        )
    with open(os.path.join(root, "transforms_mytest.json"), "w") as f:
        json.dump(
            {"camera_angle_x": camera_angle_x, "frames": mytest_frames}, f
        )
    return root
