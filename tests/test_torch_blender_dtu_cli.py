"""The Blender and DTU slice end to end on the CPU: the train CLI for one
epoch on each dataset, the eval CLI on its checkpoint against the JAX
package's ``eval.py`` (PNGs within one 8-bit level, mean PSNR within 0.01
dB, as ``tests/test_torch_eval.py`` holds LLFF), the eval CLI with its
default ``--dataset_name`` and ``--angle``, and the discriminator's patch
check on the training set's own patch.  The weights-only tool's test, on a
checkpoint of the same DTU run, is ``tests/test_torch_weights_only.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import eval as jax_eval  # noqa: E402
from sinnerf_tpu_torch import eval as port_eval  # noqa: E402
from sinnerf_tpu_torch.data.synthetic import make_blender_scene_rich, make_dtu_scene_rich  # noqa: E402
from sinnerf_tpu_torch.opt import get_opts  # noqa: E402
from sinnerf_tpu_torch.train.__main__ import main as train_main  # noqa: E402
from sinnerf_tpu_torch.train.loop import SinNeRFTrainer  # noqa: E402

BLENDER_WH, DTU_WH = (32, 32), (48, 40)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("scenes")
    return {"blender": make_blender_scene_rich(str(base / "lego"), BLENDER_WH, n_train=21),
            "dtu": make_dtu_scene_rich(str(base / "dtu"), DTU_WH, n_src=3)}


def _flags(dataset, root, tmp, *extra):
    common = ["--N_samples", "3", "--N_importance", "2", "--batch_size", "1", "--num_gpus", "1",
              "--load_depth", "--depth_weight", "8", "--depth_smooth_weight", "0.5", "--num_epochs", "1",
              "--check_val_every_n_epoch", "1", "--ckpt_dir", os.path.join(tmp, "ckpts"),
              "--log_dir", os.path.join(tmp, "logs"), "--exp_name", dataset, "--device", "cpu", "--root_dir", root]
    if dataset == "blender":
        # --angle 1 cuts the rot3d epoch to its 27-pose grid; 10 rays keep
        # one any-pixel ray
        own = ["--dataset_name", "blender_ray_patch_1image_rot3d", "--img_wh", *map(str, BLENDER_WH),
               "--patch_size", "4", "--sW", "2", "--sH", "2", "--num_rays", "10", "--dis_weight", "0", "--angle", "1"]
    else:
        # Step 2's PatchGAN on 16x16 patches, its 16 branch
        own = ["--dataset_name", "dtu_proj", "--img_wh", *map(str, DTU_WH), "--patch_size_x", "16",
               "--patch_size_y", "16", "--sW", "2", "--sH", "2", "--num_rays", "32", "--patch_size", "16",
               "--dis_weight", "0.01"]
    return common + own + list(extra)


@pytest.fixture(scope="module")
def trained(roots, tmp_path_factory):
    """dataset -> (trainer, its best checkpoint) after one epoch of the
    train CLI's ``main``."""
    out = {}
    for dataset in ("blender", "dtu"):
        tmp = str(tmp_path_factory.mktemp(dataset))
        trainer = train_main(get_opts(_flags(dataset, roots[dataset], tmp)))
        ckpt_dir = os.path.join(tmp, "ckpts", dataset)
        best = [f for f in os.listdir(ckpt_dir) if f.startswith("epoch_")]
        assert len(best) == 1 and "last.ckpt" in os.listdir(ckpt_dir)
        out[dataset] = (trainer, os.path.join(ckpt_dir, best[0]))
    return out


@pytest.mark.parametrize("dataset", ["blender", "dtu"])
def test_train_cli_runs_an_epoch(trained, dataset):
    trainer, ckpt = trained[dataset]
    steps = {"blender": 27, "dtu": 3}[dataset]  # the rot3d grid at --angle 1; DTU's source views
    assert len(trainer.train_dataset) == steps and trainer.state.step == steps
    assert np.isfinite(trainer.best_psnr) and trainer.render_settings.white_back
    blob = torch.load(ckpt, weights_only=False)
    assert blob["global_step"] == steps and blob["optimizer_states"][0]["state"]
    has_d = any(k.startswith("D.main.") for k in blob["state_dict"])
    assert has_d == (dataset == "dtu") and (len(blob["optimizer_states"]) == 2) == has_d


# Both at 32x32 (DTU's calibration follows the resize), so JAX's eval
# compiles its render once for the two
EVAL_CASES = {
    "blender_val": ("blender", "blender_ray_patch_1image_rot3d", BLENDER_WH, ["--split", "val", "--angle", "2"]),
    "dtu_val": ("dtu", "dtu_proj", (32, 32), ["--split", "val"]),
}


@pytest.mark.parametrize("name", sorted(EVAL_CASES))
def test_eval_cli_matches_jax_eval(trained, roots, tmp_path, monkeypatch, name):
    dataset, ds_name, wh, extra = EVAL_CASES[name]
    _, ckpt = trained[dataset]
    flags = ["--root_dir", roots[dataset], "--dataset_name", ds_name, "--img_wh", *map(str, wh), "--N_samples", "4",
             "--N_importance", "4", "--ckpt_path", ckpt, "--timestamp", "t", *extra]
    monkeypatch.chdir(tmp_path)
    # JAX's xla path: its interpret-mode kernels cost twice the compile time
    # (test_torch_eval.py holds the port's eval to them on LLFF)
    psnr_jax = jax_eval.main(jax_eval.get_opts(flags + ["--scene_name", "jax", "--mlp_impl", "xla"]))
    psnr_port = port_eval.main(port_eval.get_opts(flags + ["--scene_name", "port", "--device", "cpu"]))
    assert abs(psnr_port - psnr_jax) <= 0.01
    from PIL import Image

    out = tmp_path / "results" / ds_name
    names = sorted(f for f in os.listdir(out / "jax" / "t") if f.endswith(".png"))
    assert names == sorted(f for f in os.listdir(out / "port" / "t") if f.endswith(".png")) and names
    for f in names:
        want = np.asarray(Image.open(out / "jax" / "t" / f)).astype(int)
        got = np.asarray(Image.open(out / "port" / "t" / f)).astype(int)
        assert got.shape == want.shape == (wh[1], wh[0], 3)
        assert np.abs(got - want).max() <= 1, f
    assert (out / "port" / "t" / "port.gif").exists()


def test_eval_cli_runs_with_its_default_dataset(trained, roots, tmp_path, monkeypatch):
    """``python -m sinnerf_tpu_torch.eval`` with its default
    ``--dataset_name`` (blender rot3d), ``--split`` and ``--angle`` (64: the
    mytest slice starts at -34 and wraps, as in the reference)."""
    _, ckpt = trained["blender"]
    monkeypatch.chdir(tmp_path)
    args = port_eval.get_opts(["--root_dir", roots["blender"], "--ckpt_path", ckpt, "--img_wh", "16", "16",
                               "--N_samples", "3", "--N_importance", "2", "--device", "cpu"])
    assert (args.dataset_name, args.split, args.angle) == ("blender_ray_patch_1image_rot3d", "test", 64)
    psnr = port_eval.main(args)
    assert np.isfinite(psnr)
    pngs = os.listdir(tmp_path / "results" / "blender_ray_patch_1image_rot3d" / "test" / args.timestamp)
    assert sum(f.endswith(".png") for f in pngs) == 34


@pytest.mark.parametrize("patch,ok", [(16, True), (8, False)])
def test_discriminator_patch_is_the_training_sets(roots, tmp_path, patch, ok):
    """``--dis_weight 0.01`` on Blender with only ``--patch_size`` given, as
    the README's lego Step-2 recipe runs it (``--patch_size_x``/``_y`` stay
    -1): a 16-pixel patch takes D's 16 branch; an 8-pixel one is too small
    for it and is refused."""
    flags = _flags("blender", roots["blender"], str(tmp_path), "--dis_weight", "0.01")
    flags[flags.index("--patch_size") + 1] = str(patch)
    hp = get_opts(flags)
    assert (hp.patch_size_x, hp.patch_size_y, hp.dis_weight) == (-1, -1, 0.01)
    if ok:
        trainer = SinNeRFTrainer(hp)
        assert trainer.state.discriminator is not None and trainer.train_dataset.cfg.psx == patch
    else:
        with pytest.raises(ValueError, match="too small"):
            SinNeRFTrainer(hp)
