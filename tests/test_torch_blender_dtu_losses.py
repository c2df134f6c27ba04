"""The training step of the Blender and DTU slice against the JAX package:
``compute_losses`` and its gradients on a batch that the JAX package's own
``BlenderRot3D`` and ``DTUProj`` samplers drew from synthetic scenes (the
fresh warp, the any-pixel mix and both rejections in the Blender batch; the
z-buffered banks in the DTU one), held in the bands of
``tests/test_torch_train_step.py::LOSS_CASES``: the kernel path with the
Blender losses, the plain path with the DTU losses and the SSIM patch loss,
each against JAX's xla path.  The render draws come from the key JAX's step
splits (``train/step.py:133``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sinnerf_tpu.data import dataset_dict as jax_datasets
from sinnerf_tpu.render import renderer as jax_renderer
from sinnerf_tpu.train import step as jax_step
from sinnerf_tpu_torch.data.synthetic import make_blender_scene_rich, make_dtu_scene_rich
from sinnerf_tpu_torch.render import renderer as port_renderer
from sinnerf_tpu_torch.train import step as port_step
from test_torch_train_step import (
    LOSS_CASES,
    MASK_FREE_BAND,
    N_RAND,
    PS,
    _jax_grads,
    _leaf_errors,
    _mask_free,
    _models,
    _params,
    _port_draws,
    _settings,
    _t,
)

# (LOSS_CASES entry, dataset, scene writer and size, dataset flags): N_RAND
# random rays and PS x PS patches, so the step renders the N_ALL rays the
# draws of test_torch_train_step are shaped for.  JAX's side runs its xla
# path (its Pallas kernels in interpret mode take twice the compile time;
# test_torch_train_step.py holds the port's kernel path to them)
SLICE_CASES = {
    "blender_rot3d": ("kernels_blender", "blender_ray_patch_1image_rot3d", make_blender_scene_rich, (32, 32),
                      dict(patch_size=PS, sW=2, sH=2, num_rays=N_RAND)),
    "dtu": ("plain_dtu_ssim", "dtu_proj", make_dtu_scene_rich, (64, 48),
            dict(patch_size_x=PS, patch_size_y=PS, sW=3, sH=3, num_rays=N_RAND)),
}


# The one leaf pair measured outside its band (ROADMAP queue 3), by case:
# (the unit, the leaves).  On the Blender batch unit 37 of the coarse first
# layer is off by 1.67e-2 (weight) and 1.72e-2 (bias) of the leaf's largest
# entry against the band's 1e-2; the DTU batch is inside its bands.
ONE_UNIT = {"blender_rot3d": (37, ("coarse.xyz_encoding_1.0.weight", "coarse.xyz_encoding_1.0.bias"))}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def level_params():
    return {"coarse": _params(70), "fine": _params(71)}


@pytest.fixture(scope="module", params=sorted(SLICE_CASES))
def case(request, tmp_path_factory, level_params):
    """(name, the JAX batch, JAX's total, metrics and gradients, the port's
    total, metrics and gradients)."""
    loss_case, ds_name, writer, wh, flags = SLICE_CASES[request.param]
    kw = dict(n_train=21) if ds_name.startswith("blender") else dict(n_src=3)
    root = writer(str(tmp_path_factory.mktemp("scene") / "lego"), wh, **kw)
    jax_ds = jax_datasets[ds_name](root, split="train", img_wh=wh, **flags)
    batch = {k: np.asarray(v) for k, v in jax_ds.sample(jax.random.key(5), 4).items()}
    assert batch["rays"].shape == (1, N_RAND, 8) and batch["real_patch"].shape == (1, 3, PS, PS)

    impl, fields, epoch, _ = LOSS_CASES[loss_case]
    fields = dict(fields, dataset_name=ds_name)
    jcfg = jax_step.TrainConfig(render=_settings(jax_renderer, "xla"), imsize=PS, **fields)
    key = jax.random.key(13)

    def loss(p):
        total, aux = jax_step.compute_losses(p, None, None, None, None, {k: jnp.asarray(v) for k, v in batch.items()},
                                             key, jnp.asarray(epoch), jcfg)
        return total, aux["metrics"]

    (total, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, level_params))
    want = (float(total), {k: np.asarray(v) for k, v in metrics.items()}, jax.tree_util.tree_map(np.asarray, grads))

    pcfg = port_step.TrainConfig(render=_settings(port_renderer, impl), **fields)
    models = _models(level_params)
    total, aux = port_step.compute_losses(models, {k: _t(v) for k, v in batch.items()}, pcfg, epoch,
                                          _port_draws(jax.random.split(key, 6)[0]))
    total.backward()
    grads = {level: {k: p.grad.numpy() for k, p in m.state_dict(keep_vars=True).items()} for level, m in models.items()}
    return request.param, batch, want, (total.item(), aux["metrics"], grads)


def test_the_batch_is_the_datasets(case):
    """The JAX batch exercises what the slice adds: Blender's white
    background in the any-pixel rays and zero-depth patch pixels, DTU's
    z-buffered warp rays."""
    name, batch = case[:2]
    assert (batch["depth_proj"] > 0).all() and np.isfinite(batch["rays_proj"]).all()
    if name.startswith("blender"):
        assert (batch["rgbs"][0, N_RAND - N_RAND // 10:].sum(-1) == 3).any()
        assert (batch["depth_gt"] == 0).any() and (batch["depth_gt"] > 0).any()
    else:
        assert (batch["depth_gt"] > 0).all()


def test_loss_and_metrics_match_jax(case):
    _, _, (want_total, want_metrics, _), (total, metrics, _) = case
    np.testing.assert_allclose(total, want_total, rtol=1e-4)
    assert set(metrics) == set(want_metrics)
    for tag, v in want_metrics.items():
        np.testing.assert_allclose(metrics[tag].numpy(), v, rtol=1e-4, atol=1e-5, err_msg=tag)


def _rows_error(got, want):
    """Per unit of a layer (row of a weight, entry of a bias): its largest
    difference over the leaf's largest entry."""
    return np.abs(got - want).reshape(len(want), -1).max(1) / np.abs(want).max()


def test_gradients_match_jax_in_the_bands(case):
    """Every leaf in its band of LOSS_CASES, but for the pair in ONE_UNIT,
    recorded in ROADMAP queue 3: on the Blender batch one unit of the
    coarse first layer (row 37 of 256) is off by 1.7e-2 of the leaf's
    largest entry (band 1e-2), every other row of that leaf within 2.8e-4.
    A ReLU mask of that unit flipping at one point between the two sum
    orders moves that unit's delta there by its whole size and nothing else
    (the file header of test_torch_train_step.py).  Those two leaves pass
    outside the band's largest difference only in that form: their relative
    L2 inside the band, that unit within 3x the band, every other within a
    tenth of it."""
    name, _, (_, _, want_grads), (_, _, grads) = case
    band_trunk = LOSS_CASES[SLICE_CASES[name][0]][3]
    unit, excused = ONE_UNIT.get(name, (None, ()))
    want = _jax_grads({"x": (None, None, None, want_grads)}, "x")
    for leaf, err in _leaf_errors(grads, want).items():
        if _mask_free(leaf.split(".", 1)[1]):
            assert err[0] < MASK_FREE_BAND[0] and err[1] < MASK_FREE_BAND[1], (leaf, err, MASK_FREE_BAND)
        elif not (err[0] < band_trunk[0] and err[1] < band_trunk[1]):
            assert leaf in excused and err[1] < band_trunk[1], (leaf, err, band_trunk)
            level, key = leaf.split(".", 1)
            rows = _rows_error(grads[level][key], want[level][key])
            worst, second = np.argsort(rows)[::-1][:2]
            assert worst == unit and rows[unit] < 3 * band_trunk[0] and rows[second] < band_trunk[0] / 10, (
                leaf, err, worst, rows[worst], rows[second])
