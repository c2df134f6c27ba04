"""The port's prefetched sampler and the trainer's host pipeline against the
JAX package and against the port's own per-step path.

- ``sample_batches_prefetch`` given the draws JAX makes from each step's key
  (``tests/test_torch_sampler.py::_jax_draws``) against JAX's
  ``sample_batches_prefetch`` (``sinnerf_tpu/data/sampler.py:405``), slice
  by slice, on JAX's scene arrays: rtol 1e-5, atol 1e-6, as
  ``sample_item`` is held in ``test_torch_sampler.py`` (the same float32
  arithmetic summed in other orders).
- With the port's own generator, every slice of a group is bit-equal to the
  per-step ``sample`` and the per-item ``sample_item`` from the same seed,
  and the generator ends in the same state, on every training set.
- A ``torch.randint`` of a CPU generator takes one draw whatever its range
  below ``RANK_RANGE``: the pseudo-patch rank keeps its place in the stream
  before its range is read from the device.
- The trainer's ``_epoch_batches`` at ``--prefetch_batches`` 1 and 3 over 7
  steps (groups 3, 3, 1) yields the same steps and batches (port of JAX
  ``test_epoch_batches_prefetch_equivalent``); one epoch at 8 and at 1
  leaves the same trained state; the deferred log writes what the
  synchronous one would, under the same steps, its last payload included.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sinnerf_tpu.data import dataset_dict as jax_datasets
from sinnerf_tpu.data import sampler as jax_sampler
from sinnerf_tpu_torch.data import dataset_dict
from sinnerf_tpu_torch.data import sampler as port_sampler
from sinnerf_tpu_torch.data import synthetic
from tests.test_torch_sampler import _jax_draws

K, B, FIRST_STEP = 3, 2, 5
BLENDER_WH, DTU_WH, LLFF_WH = (32, 32), (64, 48), (48, 36)
ROT3D, PROJ, DTU, LLFF = ("blender_ray_patch_1image_rot3d", "blender_ray_patch_1image_proj", "dtu_proj",
                          "llff_ray_patch_1image_proj")
SETS = {
    ROT3D: ("lego", dict(img_wh=BLENDER_WH, patch_size=8, sW=2, sH=2, num_rays=64)),
    PROJ: ("lego", dict(img_wh=BLENDER_WH, patch_size=8, sW=2, sH=2, num_rays=64)),
    DTU: ("dtu", dict(img_wh=DTU_WH, patch_size_x=8, patch_size_y=10, sW=2, sH=2, num_rays=64)),
    LLFF: ("llff", dict(img_wh=LLFF_WH, patch_size_x=12, patch_size_y=9, sW=2, sH=3, num_rays=64)),
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("scenes")
    return {
        "lego": synthetic.make_blender_scene_rich(str(base / "lego"), BLENDER_WH, n_train=21),
        "dtu": synthetic.make_dtu_scene_rich(str(base / "dtu"), DTU_WH, n_src=3),
        "llff": synthetic.make_llff_scene(str(base / "llff"), LLFF_WH),
    }


@pytest.fixture(scope="module")
def port_sets(roots):
    return {name: dataset_dict[name](roots[root], split="train", **kw) for name, (root, kw) in SETS.items()}


def _steps():
    return FIRST_STEP + np.arange(K)


@pytest.mark.parametrize("name", sorted(SETS))
def test_prefetch_with_jax_draws_matches_jax(roots, name):
    root, kw = SETS[name]
    jax_ds = jax_datasets[name](roots[root], split="train", **kw)
    cfg = jax_ds.cfg
    assert cfg.reject_warp_patch == (name == ROT3D) and ("real_origins" in jax_ds.scene) == (name != LLFF)
    keys = jax.random.split(jax.random.key(11), K)
    want = jax_sampler.sample_batches_prefetch(jax_ds.scene, keys, jnp.asarray(_steps(), jnp.int32), cfg, B)
    draws = [[_jax_draws(jax_ds.scene, cfg, k) for k in jax.random.split(step_key, B)] for step_key in keys]
    scene = {k: torch.from_numpy(np.array(v)) for k, v in jax_ds.scene.items()}
    got = port_sampler.sample_batches_prefetch(scene, _steps(), port_sampler.SamplerConfig(**dataclasses.asdict(cfg)),
                                               B, draws=draws)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape == (K, B) + v.shape[2:], k
        for j in range(K):
            np.testing.assert_allclose(got[k][j].numpy(), np.asarray(v[j]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{k} step {j}")
    if cfg.reject_warp_patch:  # every pseudo patch holds a warped pixel
        assert bool((got["warp_patch_depth"].sum((-2, -1)) > 0).all())


@pytest.mark.parametrize("name", sorted(SETS))
def test_prefetch_equals_the_per_step_and_per_item_paths(port_sets, name):
    ds = port_sets[name]
    g_many, g_step, g_item = (torch.Generator().manual_seed(21) for _ in range(3))
    many = ds.sample_many(_steps(), B, g_many)
    steps = [ds.sample(int(s), B, g_step) for s in _steps()]
    items = [port_sampler.sample_item(ds.scene, int(s) * B + i, ds.cfg, generator=g_item)
             for s in _steps() for i in range(B)]
    assert {k: tuple(v.shape[:2]) for k, v in many.items()} == {k: (K, B) for k in many}
    for j in range(K):
        for k in many:
            assert torch.equal(many[k][j], steps[j][k]), (k, j)
            for i in range(B):
                assert torch.equal(many[k][j, i], items[j * B + i][k]), (k, j, i)
    assert torch.equal(g_many.get_state(), g_step.get_state())
    assert torch.equal(g_many.get_state(), g_item.get_state())
    if ds.cfg.reject_warp_patch:
        assert bool((many["warp_patch_depth"].sum((-2, -1)) > 0).all())


@pytest.mark.parametrize("high", [1, 2, 7, 13, 100_000, port_sampler.RANK_RANGE - 1])
def test_randint_takes_one_draw_whatever_its_range(high):
    def after(n):
        g = torch.Generator().manual_seed(9)
        torch.randint(0, n, (), generator=g)
        return torch.randint(0, 1000, (8,), generator=g), g.get_state()

    want, want_state = after(1)
    got, got_state = after(high)
    assert torch.equal(got, want) and torch.equal(got_state, want_state)
    # the bound is tight: a range of RANK_RANGE takes another share
    assert not torch.equal(after(port_sampler.RANK_RANGE)[0], want)


# --------------------------------------------------------------------------
# the trainer: _epoch_batches, one epoch, the deferred log
# --------------------------------------------------------------------------


def _trainer(root, tmp, prefetch: int):
    from sinnerf_tpu_torch.opt import get_opts
    from sinnerf_tpu_torch.train.loop import SinNeRFTrainer

    flags = [
        "--dataset_name", ROT3D, "--root_dir", root, "--img_wh", *map(str, BLENDER_WH), "--N_samples", "4",
        "--N_importance", "4", "--num_rays", "32", "--patch_size", "8", "--sW", "2", "--sH", "2", "--angle", "1",
        "--batch_size", "1", "--num_gpus", "1", "--dis_weight", "0", "--load_depth", "--depth_weight", "8",
        "--proj_weight", "1", "--depth_smooth_weight", "0.5", "--num_epochs", "1", "--ckpt_dir",
        os.path.join(tmp, "ckpts"), "--log_dir", os.path.join(tmp, "logs"), "--exp_name", f"k{prefetch}",
        "--device", "cpu", "--prefetch_batches", str(prefetch),
    ]
    return SinNeRFTrainer(get_opts(flags))


def test_epoch_batches_prefetch_equivalent(roots, tmp_path):
    trainer = _trainer(roots["lego"], str(tmp_path), 1)
    calls = []
    ds = trainer.train_dataset
    sample, sample_many = ds.sample, ds.sample_many
    ds.sample = lambda step, *a: calls.append([step]) or sample(step, *a)
    ds.sample_many = lambda steps, *a: calls.append(list(steps)) or sample_many(steps, *a)
    runs = {}
    for k in (1, 3):
        trainer.hparams.prefetch_batches = k
        trainer.sample_generator = torch.Generator().manual_seed(4)
        calls.clear()
        runs[k] = (list(trainer._epoch_batches(2, 7)), list(calls), trainer.sample_generator.get_state())
    assert runs[1][1] == [[s] for s in range(14, 21)]
    assert runs[3][1] == [[14, 15, 16], [17, 18, 19], [20]]
    assert [i for i, _ in runs[1][0]] == [i for i, _ in runs[3][0]] == list(range(7))
    for (_, want), (_, got) in zip(runs[1][0], runs[3][0]):
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert torch.equal(runs[1][2], runs[3][2])


class _Recorder:
    """A TensorBoard writer that keeps what it is given."""

    def __init__(self):
        self.records = []

    def add_scalar(self, tag, value, step):
        self.records.append((tag, step, float(value)))

    def add_images(self, tag, images, step):
        self.records.append((tag, step, np.array(images)))

    def close(self):
        pass


def test_one_epoch_prefetched_trains_as_per_step_and_logs_as_synchronously(roots, tmp_path, monkeypatch):
    """One epoch of the 27-pose rot3d grid (groups 8, 8, 8, 3) against one
    step by step: the same weights, Adam state and generators.  The
    prefetched run logs through a recording writer; the synchronous log is
    written at each log step from the step's own output."""
    from sinnerf_tpu_torch.train import loop

    sync = _Recorder()
    train_step = loop.train_step
    current = {}

    def recording_step(state, *args, **kwargs):
        state, out = train_step(state, *args, **kwargs)
        if current.get("trainer") is not None and state.step % 10 == 0:
            trainer = current["trainer"]
            metrics = {k: v.clone() for k, v in out["metrics"].items()}
            images = {k: out["images"][k][0].clone() for k in loop.LOG_IMAGE_KEYS}
            writer, trainer.writer = trainer.writer, sync
            trainer._log_scalars(metrics, state.step, loop.lr_for_epoch(trainer.hparams, 0))
            trainer._log_images(images, state.step)
            trainer.writer = writer
        return state, out

    monkeypatch.setattr(loop, "train_step", recording_step)
    trainers = {k: _trainer(roots["lego"], str(tmp_path), k) for k in (8, 1)}
    assert trainers[8].steps_per_epoch() == 27
    deferred = trainers[8].writer = _Recorder()
    trainers[1].writer = None
    for k in (8, 1):
        current["trainer"] = trainers[k] if k == 8 else None
        trainers[k]._run_epoch(0, trainers[k].steps_per_epoch())
    assert trainers[8].state.step == trainers[1].state.step == 27
    for level, model in trainers[8].state.models.items():
        want = trainers[1].state.models[level].state_dict()
        for name, got in model.state_dict().items():
            assert torch.equal(got, want[name]), (level, name)
    opt_got, opt_want = trainers[8].state.opt_g.state_dict(), trainers[1].state.opt_g.state_dict()
    for idx, moments in opt_want["state"].items():
        for name, want in moments.items():
            assert torch.equal(torch.as_tensor(opt_got["state"][idx][name]), torch.as_tensor(want)), (idx, name)
    for gen in ("sample_generator", "render_generator", "host_generator"):
        assert torch.equal(getattr(trainers[8], gen).get_state(), getattr(trainers[1], gen).get_state()), gen

    logged = [r for r in deferred.records if r[0] != "train/epoch_time"]
    assert deferred.records[-1][0] == "train/epoch_time"
    assert sorted({step for _, step, _ in logged}) == [10, 20]  # the epoch's last payload too
    assert [(tag, step) for tag, step, _ in logged] == [(tag, step) for tag, step, _ in sync.records]
    assert {"lr", "train/psnr", "train/images", "train/images_side"} <= {tag for tag, _, _ in logged}
    for (tag, step, got), (_, _, want) in zip(logged, sync.records):
        assert np.array_equal(got, want), (tag, step)
