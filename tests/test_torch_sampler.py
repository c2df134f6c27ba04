"""The port's warp, sampler and LLFF training set against the JAX package.

The deterministic pieces are held equal: the warp winners and warped images
(z-buffered with the first writer on ties, and last-write), the real-patch
origins, strided patches, the ``LLFFProj`` scene arrays on the same
synthetic scene, and ``sample_item`` given JAX's own draws (replayed from
the key JAX's ``sample_item`` splits, ``sampler.py:257-356``).  Float
arrays: rtol 1e-6 (the same float32 arithmetic; the projection matrices are
float64 on both sides before the cast).  The draws the port makes itself
are checked by range and shape.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sinnerf_tpu.data import jnp_poses
from sinnerf_tpu.data import sampler as jax_sampler
from sinnerf_tpu.data.llff import LLFFProj as JaxLLFFProj
from sinnerf_tpu.data.synthetic import make_llff_scene
from sinnerf_tpu.ops import warp as jax_warp
from sinnerf_tpu_torch.data import dataset_dict
from sinnerf_tpu_torch.data import poses as port_poses
from sinnerf_tpu_torch.data import sampler as port_sampler
from sinnerf_tpu_torch.data.llff import LLFFProj
from sinnerf_tpu_torch.ops import warp as port_warp

WH = (64, 48)
PSX, PSY, S_ROW, S_COL, NUM_RAYS = 16, 12, 2, 3, 96


@pytest.fixture(scope="module")
def llff_root(tmp_path_factory):
    return make_llff_scene(str(tmp_path_factory.mktemp("llff")), WH)


def _kwargs():
    return dict(img_wh=WH, patch_size_x=PSX, patch_size_y=PSY, sW=S_ROW, sH=S_COL, num_rays=NUM_RAYS)


@pytest.fixture(scope="module")
def datasets(llff_root):
    return JaxLLFFProj(llff_root, split="train", **_kwargs()), LLFFProj(llff_root, split="train", **_kwargs())


def _warp_inputs(datasets):
    """A bumpy depth map (so that splats collide) and two real poses'
    float64 projections, cast to float32 as the datasets cast them."""
    jax_ds, _ = datasets
    rng = np.random.default_rng(0)
    depth = np.array(jax_ds.scene["ref_depth"] * (1.0 + 0.3 * rng.uniform(size=jax_ds.scene["ref_depth"].shape)),
                     dtype=np.float32)
    depth[::7, ::5] = 0.0  # holes: a non-positive depth never wins
    projs = [port_poses.projection_matrix(torch.as_tensor(jax_ds.k3, dtype=torch.float64),
                                          port_poses.c2w_to_w2c_cv(torch.as_tensor(jax_ds.poses[i], dtype=torch.float64)))
             .numpy().astype(np.float32) for i in (1, 3)]
    return depth, projs[0], projs[1]


@pytest.mark.parametrize("zbuffer", [True, False])
def test_warp_matches_jax(datasets, zbuffer):
    depth, ref_p, src_p = _warp_inputs(datasets)
    win_j, d_j = jax_warp.warp_winner(jnp.asarray(depth), jnp.asarray(ref_p), jnp.asarray(src_p), zbuffer=zbuffer)
    win_p, d_p = port_warp.warp_winner(torch.from_numpy(depth), torch.from_numpy(ref_p), torch.from_numpy(src_p), zbuffer)
    win_j = np.asarray(win_j)
    assert (win_j >= 0).sum() > 100 and (win_j < 0).sum() > 10
    assert len(np.unique(win_j[win_j >= 0])) < (depth > 0).sum()  # splats collided
    np.testing.assert_array_equal(win_p.numpy(), win_j)
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), rtol=1e-6)
    img = np.random.default_rng(1).uniform(size=depth.shape + (3,)).astype(np.float32)
    out_j = jax_warp.forward_warp(jnp.asarray(img), jnp.asarray(depth), jnp.asarray(ref_p), jnp.asarray(src_p), zbuffer)
    out_p = port_warp.forward_warp(torch.from_numpy(img), torch.from_numpy(depth), torch.from_numpy(ref_p),
                                   torch.from_numpy(src_p), zbuffer)
    for a, b in zip(out_p, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    np.testing.assert_array_equal(port_warp.warp_valid_mask(out_p[0]).numpy(),
                                  np.asarray(jax_warp.warp_valid_mask(out_j[0])))


def test_zbuffer_keeps_the_nearest_and_the_first_writer():
    """Four pixels splat onto one target at depths 3, 2, 2, -1: the first of
    the two at depth 2 wins (the painter's strict ``>``); the negative one
    never does."""
    depth = torch.tensor([[3.0, 2.0, 2.0, -1.0]])
    eye = torch.eye(4)
    squash = torch.eye(4)
    squash[0, 0] = 0.0  # every pixel lands on column 0
    win, _ = port_warp.warp_winner(depth, eye, squash, zbuffer=True)
    assert win.tolist() == [1, -1, -1, -1]
    win, _ = port_warp.warp_winner(depth, eye, squash, zbuffer=False)
    assert win.tolist() == [3, -1, -1, -1]


@pytest.mark.parametrize("mode", ["none", "max_nonzero", "mean_gt_001"])
def test_real_origins_and_patches_match_jax(datasets, mode):
    jax_ds, port_ds = datasets
    img = np.array(jax_ds.scene["ref_image"])
    img[:40, :50] = 0.0  # a dark corner: the patches inside it are rejected
    cfg_j = jax_sampler.SamplerConfig(48, 64, PSX, PSY, S_ROW, S_COL, reject_real_patch=mode)
    cfg_p = port_sampler.SamplerConfig(48, 64, PSX, PSY, S_ROW, S_COL, reject_real_patch=mode)
    want, got = jax_sampler.compute_real_origins(img, cfg_j), port_sampler.compute_real_origins(img, cfg_p)
    if mode == "none":
        assert want is None and got is None
    else:
        assert 0 < len(got) < cfg_p.row_limit * cfg_p.col_limit
        np.testing.assert_array_equal(got, want)
    corners = ((0, 0), (5, 7), (cfg_p.row_limit - 1, cfg_p.col_limit - 1))
    codes = torch.tensor([ll * cfg_p.col_limit + up for ll, up in corners])
    patches = torch.from_numpy(img).reshape(-1, 3)[port_sampler.patch_pixels(codes, cfg_p, 64)]
    for (ll, up), patch in zip(corners, patches):
        np.testing.assert_array_equal(
            patch.numpy(), np.asarray(jax_sampler.strided_patch(jnp.asarray(img), ll, up, PSX, PSY, S_ROW, S_COL)))


def test_llff_scene_matches_jax(datasets):
    jax_ds, port_ds = datasets
    assert set(port_ds.scene) == set(jax_ds.scene)
    for k, v in jax_ds.scene.items():
        got = port_ds.scene[k].numpy()
        assert got.shape == v.shape, k
        np.testing.assert_allclose(got, np.asarray(v), rtol=1e-6, err_msg=k)
    assert len(port_ds) == len(jax_ds) and port_ds.cfg.row_limit == jax_ds.cfg.row_limit
    assert (port_ds.ref_idx, port_ds.val_idx) == (jax_ds.ref_idx, jax_ds.val_idx)


@pytest.mark.parametrize("split", ["val", "test", "test_train"])
def test_llff_eval_splits_match_jax(llff_root, split):
    jax_ds = JaxLLFFProj(llff_root, split=split, img_wh=WH)
    port_ds = dataset_dict["llff_ray_patch_1image_proj"](llff_root, split=split, img_wh=WH)
    assert port_ds.val_len() == jax_ds.val_len()
    for i in (0, port_ds.val_len() - 1):
        a, b = port_ds.val_item(i), jax_ds.val_item(i)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=1e-6, atol=1e-7, err_msg=k)


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
    """The draws JAX's ``sample_item`` makes from ``key``
    (``sampler.py:257-356``): the any-pixel mix, the real-origin draw and
    the warp-patch rank where the configuration rejects patches."""
    keys = jax.random.split(key, 8)
    n_main = cfg.num_rays - cfg.n_any
    n_proj = cfg.n_proj or cfg.num_rays

    def t(a):
        return torch.from_numpy(np.array(a)).long()

    def corner(k):
        k_ll, k_up = jax.random.split(k)
        return torch.tensor([int(jax.random.randint(k_ll, (), 0, cfg.row_limit)),
                             int(jax.random.randint(k_up, (), 0, cfg.col_limit))])

    angles = jax.random.normal(keys[4], (3,)) * (cfg.angle // 2)
    draws = dict(
        rays=t(jax.random.randint(keys[0], (n_main,), 0, scene["pool"].shape[0])),
        proj=t(jax.random.randint(keys[2], (n_proj,), 0, scene["proj_depth"].shape[0])),
        angles=torch.from_numpy(np.array(angles)),
    )
    if cfg.n_any:
        draws["any_rays"] = t(jax.random.randint(keys[1], (cfg.n_any,), 0, scene["any"].shape[0]))
    if "real_origins" in scene:
        origins = scene["real_origins"]
        code = int(origins[int(jax.random.randint(keys[3], (), 0, origins.shape[0]))])
        draws["real_corner"] = torch.tensor([code // cfg.col_limit, code % cfg.col_limit])
    else:
        draws["real_corner"] = corner(keys[3])
    if cfg.reject_warp_patch:  # the rank among the fresh warp's valid origins (sampler.py:138-152)
        valid = int(_valid_warp_origins(scene["ref_c2w"], scene["k3"], scene["ref_depth"], angles, cfg))
        draws["patch_rank"] = t(jax.random.randint(keys[5], (), 0, max(valid, 1)))
    else:
        draws["patch_corner"] = corner(keys[5])
    return port_sampler.ItemDraws(**draws)


@pytest.mark.parametrize("fresh_warp", [False, True])
def test_sample_item_with_jax_draws_matches_jax(datasets, fresh_warp):
    """Every key of an item, given the draws JAX makes: the bank pseudo view
    of ``LLFFProj``, and a fresh gaussian warp (last-write) of its scene."""
    import dataclasses

    jax_ds, port_ds = datasets
    cfg_j = dataclasses.replace(jax_ds.cfg, fresh_warp=fresh_warp)
    cfg_p = dataclasses.replace(port_ds.cfg, fresh_warp=fresh_warp)
    key = jax.random.key(3)
    want = jax_sampler.sample_item(jax_ds.scene, key, jnp.asarray(7), cfg_j)
    got = port_sampler.sample_item(port_ds.scene, 7, cfg_p, _jax_draws(jax_ds.scene, cfg_j, key))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-6, err_msg=k)


def test_own_draws_have_the_schema_and_ranges(datasets):
    _, port_ds = datasets
    g = torch.Generator().manual_seed(0)
    batch = port_ds.sample(3, batch_size=2, generator=g)
    shapes = {
        "rays": (2, NUM_RAYS, 8), "rgbs": (2, NUM_RAYS, 3), "depth": (2, NUM_RAYS, 1),
        "rays_proj": (2, NUM_RAYS, 8), "depth_proj": (2, NUM_RAYS, 1), "real_patch": (2, 3, PSX, PSY),
        "rays_full": (2, PSX * PSY, 8), "warp_patch": (2, 3, PSX, PSY), "warp_patch_depth": (2, PSX, PSY),
        "depth_ray": (2, PSX * PSY, 8), "depth_gt": (2, PSX * PSY, 1), "depth_ray_rgb": (2, PSX * PSY, 3),
    }
    assert {k: tuple(v.shape) for k, v in batch.items()} == shapes
    assert bool((batch["depth_proj"] > 0).all())  # drawn from the valid warped pixels only
    np.testing.assert_allclose(batch["rays"][..., 6].numpy(), port_ds.near, rtol=1e-6)
    again = port_ds.sample(3, batch_size=2, generator=torch.Generator().manual_seed(0))
    for k in batch:
        torch.testing.assert_close(batch[k], again[k], rtol=0, atol=0)


def test_reject_warp_patch_draws_a_valid_origin():
    """With ``reject_warp_patch`` the pseudo-view patch's warp depth is never
    all zero when a valid origin exists (the reference's redraw loop)."""
    h, w = 20, 24
    cfg = port_sampler.SamplerConfig(h, w, 4, 4, 1, 1, num_rays=8, reject_warp_patch=True)
    depth = torch.zeros(h, w)
    depth[15:18, 2:5] = 1.0  # a single small island
    rng = np.random.default_rng(0)
    scene = {
        "ref_image": torch.rand(h, w, 3), "ref_depth": depth, "directions": torch.randn(h, w, 3),
        "pool": torch.rand(h * w, 12), "proj_pose": torch.zeros(5, dtype=torch.long),
        "proj_pix": torch.arange(5), "proj_depth": torch.ones(5), "bank_c2w": torch.eye(4)[:3][None],
        "bank_rgb": torch.rand(1, 3, h, w), "bank_depth": depth[None], "k3": torch.eye(3),
        "ref_c2w": torch.eye(4)[:3], "near_far": torch.tensor([1.0, 2.0]),
    }
    g = torch.Generator().manual_seed(int(rng.integers(1000)))
    for _ in range(20):
        item = port_sampler.sample_item(scene, 0, cfg, generator=g)
        assert float(item["warp_patch_depth"].sum()) > 0
