"""The port's Blender and DTU training sets, their pose and ray helpers and
the synthetic scene writers, against the JAX package.

Held bit for bit: the pose helpers and ray directions, every file each
writer writes (plain and rich, at small sizes), the train scenes' arrays
that do not come out of the depth warp (``pool``, ``any``, ``directions``,
``k3``, ``ref_c2w``, ``near_far``, ``bank_c2w``, ``real_origins``, the
reference image and depth), the sampler configuration and ``len()``, and
every val split's rays, RGBs and names.

The warp banks and the projected-ray index come out of a float32 4x4
inverse (``ops/warp.py::project_pixels``), which torch and XLA round
differently by an ulp.  Where a projected coordinate lies within that of
a pixel edge the splat lands on the neighbour: on the rot3d grid at 32x32,
102 of 32,165 valid warped pixels (0.32%) differ; the proj and DTU banks
keep the same pixels, their depths within one ulp.  The index is held to a
symmetric difference below 1% (rot3d) or none (proj, DTU), the bank
depths to rtol 1e-6 and atol 5e-7, an ulp at the scene's depths (ROADMAP
queue 3).

``sample_item`` is held on JAX's own scene arrays with the draws JAX's key
gives (``sampler.py:220-386``), rtol 1e-5: the fresh warp of rot3d (its
any-pixel mix, real-origin draw and warp-patch rejection), the bank of
proj, DTU's.
"""

import dataclasses
import filecmp
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sinnerf_tpu.core import rays as jax_rays
from sinnerf_tpu.data import dataset_dict as jax_datasets
from sinnerf_tpu.data import jnp_poses
from sinnerf_tpu.data import poses as jax_poses
from sinnerf_tpu.data import sampler as jax_sampler
from sinnerf_tpu.data import synthetic as jax_synthetic
from sinnerf_tpu.ops import warp as jax_warp
from sinnerf_tpu_torch.core import rays as port_rays
from sinnerf_tpu_torch.data import dataset_dict
from sinnerf_tpu_torch.data import poses as port_poses
from sinnerf_tpu_torch.data import sampler as port_sampler
from sinnerf_tpu_torch.data import synthetic as port_synthetic
from sinnerf_tpu_torch.ops import warp as port_warp

BLENDER_WH, DTU_WH = (32, 32), (64, 48)
ROT3D, PROJ, DTU = "blender_ray_patch_1image_rot3d", "blender_ray_patch_1image_proj", "dtu_proj"
BLENDER_KW = dict(img_wh=BLENDER_WH, patch_size=8, sW=2, sH=2, num_rays=64)
DTU_KW = dict(img_wh=DTU_WH, patch_size_x=8, patch_size_y=10, sW=2, sH=2, num_rays=64)
WARPED = ("proj_pose", "proj_pix", "proj_depth", "bank_rgb", "bank_depth")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The rich lego stand-in (21 frames: ref 20 exists, a true mytest
    split, and a my_testset depth for depth_type 'gt'), a plain Blender
    scene (no mytest slice: not named lego) and a rich DTU scan."""
    base = tmp_path_factory.mktemp("scenes")
    lego = port_synthetic.make_blender_scene_rich(str(base / "lego"), BLENDER_WH, n_train=21)
    os.makedirs(os.path.join(lego, "my_testset"))
    gt = np.random.default_rng(3).uniform(2.0, 6.0, size=BLENDER_WH[::-1] + (3,)).astype(np.float32)
    gt[:5] = 1e4  # the background's far value, zeroed by the loader
    np.save(os.path.join(lego, "my_testset", "mytest_29_400.npy"), gt)
    return {
        "lego": lego,
        "plain": port_synthetic.make_blender_scene(str(base / "scene"), BLENDER_WH),
        "dtu": port_synthetic.make_dtu_scene_rich(str(base / "dtu"), DTU_WH, n_src=3),
    }


# --------------------------------------------------------------------------
# pose and ray helpers
# --------------------------------------------------------------------------

_C2W = np.array([[0.8, -0.2, 0.56, 1.1], [0.3, 0.9, -0.3, -0.4], [-0.5, 0.4, 0.76, 4.0]])
_K = np.array([[30.5, 0.0, 15.5], [0.0, 31.25, 12.0], [0.0, 0.0, 1.0]])
_CAMERAS = np.array([[1.0, 2.0, 3.0], [0.0, 0.0, 2.0], [-1.5, 0.5, 0.2]])  # the second on the up axis

HELPER_CASES = {
    "trans_t": (lambda m: m.trans_t(2.5),) * 2,
    "rot_z": (lambda m: m.rot_z(0.7),) * 2,
    "rotate_3d": (lambda m: m.rotate_3d_np(_C2W, 12, -7.5, 20), lambda m: m.rotate_3d(_C2W, 12, -7.5, 20)),
    "to_homo": (lambda m: m.to_homo(_C2W),) * 2,
    "invert_pose": (lambda m: m.invert_pose(_C2W),) * 2,
    "convert_c2w_to_w2c_cv": (lambda m: m.convert_c2w_to_w2c_cv(_C2W),) * 2,
    "projection_matrix": (lambda m: m.projection_matrix_np(_K, m.convert_c2w_to_w2c_cv(_C2W)),
                          lambda m: m.projection_matrix(_K, m.convert_c2w_to_w2c_cv(_C2W))),
    "rot3d_grid": (lambda m: m.rot3d_grid(_C2W, 20),) * 2,
    "rot3d_grid_odd": (lambda m: m.rot3d_grid(_C2W, 7),) * 2,
    "rot_z_linspace": (lambda m: m.rot_z_linspace(_C2W, 20, 60),) * 2,
    "look_at_rotation": (lambda m: m.look_at_rotation(_CAMERAS),) * 2,
    "pose_spherical_dtu": (lambda m: m.pose_spherical_dtu(np.array([0.3, 0.2, 0.1]), 4.5, 12,
                                                           np.array([0.5, -0.25, 1.0])),) * 2,
}


@pytest.mark.parametrize("name", sorted(HELPER_CASES))
def test_pose_helpers_equal_jax(name):
    port_fn, jax_fn = HELPER_CASES[name]
    got, want = port_fn(port_poses), jax_fn(jax_poses)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k_dtype", [np.float32, np.float64])
def test_ray_directions_pz_equal_jax(k_dtype):
    k = _K.astype(k_dtype)
    got = port_rays.get_ray_directions_pz(24, 32, k).numpy()
    want = np.asarray(jax_rays.get_ray_directions_pz(24, 32, k))
    assert got.shape == (24, 32, 3) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# synthetic scene writers
# --------------------------------------------------------------------------

WRITER_CASES = {
    "make_blender_scene": dict(img_wh=(32, 32)),
    "make_dtu_scene": dict(img_wh=(32, 32)),
    "make_llff_scene": dict(img_wh=(32, 24)),
    "make_blender_scene_rich": dict(img_wh=(32, 32), n_train=3),
    "make_dtu_scene_rich": dict(img_wh=(64, 48), n_src=2),
    "make_llff_scene_rich": dict(img_wh=(32, 24), n_images=3),
}


@pytest.mark.parametrize("name", sorted(WRITER_CASES))
def test_writers_write_the_jax_files(tmp_path, name):
    want = getattr(jax_synthetic, name)(str(tmp_path / "jax"), **WRITER_CASES[name])
    got = getattr(port_synthetic, name)(str(tmp_path / "port"), **WRITER_CASES[name])
    files = sorted(os.path.relpath(os.path.join(d, f), want) for d, _, fs in os.walk(want) for f in fs)
    got_files = sorted(os.path.relpath(os.path.join(d, f), got) for d, _, fs in os.walk(got) for f in fs)
    assert files == got_files and len(files) >= 7
    differ = [f for f in files if not filecmp.cmp(os.path.join(want, f), os.path.join(got, f), shallow=False)]
    assert not differ, differ


# --------------------------------------------------------------------------
# the train scenes
# --------------------------------------------------------------------------

SCENE_CASES = {
    "rot3d_lego": (ROT3D, "lego", dict(BLENDER_KW)),
    "rot3d_plain": (ROT3D, "plain", dict(BLENDER_KW, ref_idx=0)),
    "rot3d_lego_gt": (ROT3D, "lego", dict(BLENDER_KW, depth_type="gt")),
    "proj_lego": (PROJ, "lego", dict(BLENDER_KW)),
    "dtu": (DTU, "dtu", dict(DTU_KW)),
}


def _build(roots, name, split="train", **extra):
    ds_name, root, kw = SCENE_CASES[name]
    kw = dict(kw, **extra)
    return jax_datasets[ds_name](roots[root], split=split, **kw), dataset_dict[ds_name](roots[root], split=split, **kw)


@pytest.fixture(scope="module")
def scenes(roots):
    return {name: _build(roots, name) for name in SCENE_CASES}


@pytest.mark.parametrize("name", sorted(SCENE_CASES))
def test_train_scene_matches_jax(scenes, name):
    jax_ds, port_ds = scenes[name]
    assert set(port_ds.scene) == set(jax_ds.scene)
    for key, value in jax_ds.scene.items():
        want, got = np.asarray(value), port_ds.scene[key].numpy()
        assert got.shape == want.shape or key in WARPED[:3], key
        if key not in WARPED:
            np.testing.assert_array_equal(got, want, err_msg=key)
    assert dataclasses.asdict(port_ds.cfg) == dataclasses.asdict(jax_ds.cfg)
    assert len(port_ds) == len(jax_ds) and getattr(port_ds, "ref_idx", None) == getattr(jax_ds, "ref_idx", None)
    assert port_ds.white_back and float(port_ds.scene["ref_depth"].max()) > 0

    want = set(zip(np.asarray(jax_ds.scene["proj_pose"]).tolist(), np.asarray(jax_ds.scene["proj_pix"]).tolist()))
    got = set(zip(port_ds.scene["proj_pose"].tolist(), port_ds.scene["proj_pix"].tolist()))
    share = len(want ^ got) / len(want)
    if port_ds.cfg.fresh_warp:  # the rot3d grid: a few splats on a pixel edge land on the neighbour
        assert share < 1e-2, share
    else:
        assert share == 0.0
        for key in WARPED:
            np.testing.assert_allclose(port_ds.scene[key].numpy(), np.asarray(jax_ds.scene[key]), rtol=1e-6,
                                       atol=5e-7, err_msg=key)


VAL_CASES = {
    "blender_val_mytest": (ROT3D, "lego", "val", {}),
    "blender_val_mytest_angle64": (ROT3D, "lego", "val", dict(angle=64)),
    "blender_val_ref_frame": (ROT3D, "plain", "val", dict(ref_idx=1)),
    "blender_test_train": (ROT3D, "lego", "test_train", {}),
    "blender_test_train2": (ROT3D, "lego", "test_train2", {}),
    "blender_test_train2_gt": (ROT3D, "lego", "test_train2", dict(depth_type="gt")),
    "blender_val_gt": (ROT3D, "lego", "val", dict(depth_type="gt")),
    "proj_val": (PROJ, "lego", "val", dict(angle=10)),
    "dtu_val": (DTU, "dtu", "val", {}),
}


@pytest.mark.parametrize("name", sorted(VAL_CASES))
def test_val_split_matches_jax(roots, name):
    ds_name, root, split, extra = VAL_CASES[name]
    wh = DTU_WH if ds_name == DTU else BLENDER_WH
    jax_ds = jax_datasets[ds_name](roots[root], split=split, img_wh=wh, **extra)
    port_ds = dataset_dict[ds_name](roots[root], split=split, img_wh=wh, **extra)
    assert port_ds.val_len() == jax_ds.val_len() > 0 and len(port_ds) == len(jax_ds)
    assert port_ds.white_back == jax_ds.white_back
    for i in range(port_ds.val_len()):
        got, want = port_ds.val_item(i), jax_ds.val_item(i)
        assert set(got) == set(want)
        for key in got:
            if key == "fname":
                assert got[key] == want[key]
            else:
                np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=f"{i} {key}")


# --------------------------------------------------------------------------
# one sampled item per dataset, with JAX's draws
# --------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=4)
def _valid_warp_origins(ref_c2w, k3, ref_depth, angles, cfg):
    """How many pseudo-patch origins JAX's fresh warp leaves valid
    (``sampler.py:303-339``)."""
    pseudo = jnp_poses.rotate_3d(ref_c2w, *angles)
    ref_p = jnp_poses.projection_matrix(k3, jnp_poses.c2w_to_w2c_cv(ref_c2w))
    src_p = jnp_poses.projection_matrix(k3, jnp_poses.c2w_to_w2c_cv(pseudo))
    win, d_flat = jax_warp.warp_winner(ref_depth, ref_p, src_p, zbuffer=False)
    depth = jnp.where(win >= 0, d_flat[jnp.maximum(win, 0)], 0.0).reshape(ref_depth.shape)
    return (jax_sampler._strided_sum_map(depth, cfg) != 0).sum()


def _jax_draws(scene, cfg, key):
    """The draws JAX's ``sample_item`` makes from ``key``, the rejections
    included (``sampler.py:220-386``)."""
    keys = jax.random.split(key, 8)
    n_proj = cfg.n_proj or cfg.num_rays

    def t(a):
        return torch.from_numpy(np.array(a)).long()

    code = int(scene["real_origins"][int(jax.random.randint(keys[3], (), 0, scene["real_origins"].shape[0]))])
    angles = jax.random.normal(keys[4], (3,)) * (cfg.angle // 2)
    draws = dict(
        rays=t(jax.random.randint(keys[0], (cfg.num_rays - cfg.n_any,), 0, scene["pool"].shape[0])),
        proj=t(jax.random.randint(keys[2], (n_proj,), 0, scene["proj_depth"].shape[0])),
        real_corner=torch.tensor([code // cfg.col_limit, code % cfg.col_limit]),
        angles=torch.from_numpy(np.array(angles)),
    )
    if cfg.n_any:
        draws["any_rays"] = t(jax.random.randint(keys[1], (cfg.n_any,), 0, scene["any"].shape[0]))
    if cfg.reject_warp_patch:  # the rank among the fresh warp's valid origins (sampler.py:138-152)
        valid = int(_valid_warp_origins(scene["ref_c2w"], scene["k3"], scene["ref_depth"], angles, cfg))
        assert valid > 0
        draws["patch_rank"] = t(jax.random.randint(keys[5], (), 0, max(valid, 1)))
    else:
        k_ll, k_up = jax.random.split(keys[5])
        draws["patch_corner"] = torch.tensor([int(jax.random.randint(k_ll, (), 0, cfg.row_limit)),
                                              int(jax.random.randint(k_up, (), 0, cfg.col_limit))])
    return port_sampler.ItemDraws(**draws)


@pytest.mark.parametrize("name", ["rot3d_lego", "proj_lego", "dtu"])
def test_sample_item_with_jax_draws_matches_jax(scenes, name):
    jax_ds, port_ds = scenes[name]
    key = jax.random.key(7)
    want = jax.jit(jax_sampler.sample_item, static_argnums=3)(jax_ds.scene, key, jnp.asarray(3), jax_ds.cfg)
    scene = {k: torch.from_numpy(np.array(v)) for k, v in jax_ds.scene.items()}
    got = port_sampler.sample_item(scene, 3, port_ds.cfg, _jax_draws(jax_ds.scene, jax_ds.cfg, key))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(got["warp_patch_depth"].sum()) > 0  # the warp patch is never all holes


@pytest.mark.parametrize("name", ["rot3d_lego", "dtu"])
def test_own_draws_have_the_schema_and_ranges(scenes, name):
    """The port's own draws: shapes, the blender any-pixel mix, valid
    projected rays, and the same items from the same seed."""
    _, port_ds = scenes[name]
    cfg = port_ds.cfg
    n_rays, n_proj, patch = cfg.num_rays, cfg.n_proj or cfg.num_rays, cfg.psx * cfg.psy
    batch = port_ds.sample(2, batch_size=2, generator=torch.Generator().manual_seed(0))
    shapes = {
        "rays": (2, n_rays, 8), "rgbs": (2, n_rays, 3), "depth": (2, n_rays, 1), "rays_proj": (2, n_proj, 8),
        "depth_proj": (2, n_proj, 1), "real_patch": (2, 3, cfg.psx, cfg.psy), "rays_full": (2, patch, 8),
        "warp_patch": (2, 3, cfg.psx, cfg.psy), "warp_patch_depth": (2, cfg.psx, cfg.psy),
        "depth_ray": (2, patch, 8), "depth_gt": (2, patch, 1), "depth_ray_rgb": (2, patch, 3),
    }
    assert {k: tuple(v.shape) for k, v in batch.items()} == shapes
    assert bool((batch["depth_proj"] > 0).all())
    assert bool((batch["real_patch"].amax(dim=(1, 2, 3)) > 0).all())
    if cfg.n_any:  # the any-pixel rays come last and reach the white background
        assert bool((batch["rgbs"][:, n_rays - cfg.n_any:].sum(-1) == 3).any())
        assert bool((batch["rgbs"][:, : n_rays - cfg.n_any].sum(-1) != 3).all())
    again = port_ds.sample(2, batch_size=2, generator=torch.Generator().manual_seed(0))
    for k in batch:
        torch.testing.assert_close(batch[k], again[k], rtol=0, atol=0)


@pytest.mark.parametrize("zbuffer", [True, False])
def test_warp_sends_a_nan_splat_to_pixel_0_as_jax(zbuffer):
    """A pixel of depth 0 seen from its own camera projects to 0/0 (the
    rot3d grid's identity rotation over a background pixel): JAX's
    conversion sends the NaN to pixel 0; the port did not (it raised)."""
    depth = np.random.default_rng(4).uniform(2.0, 6.0, size=(6, 8)).astype(np.float32)
    depth[2:4, 3:6] = 0.0
    eye = np.eye(4, dtype=np.float32)
    win_j, d_j = jax_warp.warp_winner(jnp.asarray(depth), jnp.asarray(eye), jnp.asarray(eye), zbuffer=zbuffer)
    win_p, d_p = port_warp.warp_winner(torch.from_numpy(depth), torch.from_numpy(eye), torch.from_numpy(eye), zbuffer)
    np.testing.assert_array_equal(win_p.numpy(), np.asarray(win_j))
    np.testing.assert_array_equal(d_p.numpy(), np.asarray(d_j))
