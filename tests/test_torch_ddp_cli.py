"""The port's CLIs on two gloo ranks (``--device cpu --num_gpus 2``): the
train CLI with the ViT on (its per-item cache is what a rank owns of the
global batch), a resume on two ranks, and the eval CLI against itself on one
rank.

The train CLI: ``steps_per_epoch`` is ceil(len / 2) (the global batch is
``batch_size * num_gpus``, JAX ``loop.py:103-116``), every rank ends at the
same best val PSNR, rank 0 alone writes checkpoints and TensorBoard, and the
checkpoint's ViT cache holds the global batch's two rows.  A resume gives
each rank its own row.  The eval CLI's PNGs at two ranks equal
those at one (the sharded render is bit-equal to the one-process one,
``tests/test_torch_ddp.py``), its mean PSNR too.
"""

import math
import os

import numpy as np
import pytest
import torch

import ddp_workers
from sinnerf_tpu_torch import eval as port_eval
from sinnerf_tpu_torch.opt import get_opts
from sinnerf_tpu_torch.parallel import ddp
from sinnerf_tpu_torch.train.__main__ import main as train_main

WH = (32, 24)


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_rank():
    """``launch`` gives each of the two ranks half of this process's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(flags, the ranks' summaries) of one epoch of the train CLI on two
    ranks, the ViT on."""
    from sinnerf_tpu_torch.data.synthetic import make_llff_scene

    tmp = tmp_path_factory.mktemp("ddp_cli")
    root = make_llff_scene(str(tmp / "llff"), WH)
    flags = [
        "--dataset_name", "llff_ray_patch_1image_proj", "--root_dir", root, "--img_wh", str(WH[0]), str(WH[1]),
        "--N_samples", "4", "--N_importance", "4", "--num_rays", "32", "--patch_size_x", "16", "--patch_size_y",
        "16", "--sW", "1", "--sH", "1", "--batch_size", "1", "--num_gpus", "2", "--dis_weight", "0",
        "--vit_weight", "10", "--allow_random_pretrained", "--load_depth", "--depth_weight", "8",
        "--num_epochs", "1", "--check_val_every_n_epoch", "1", "--ckpt_dir", str(tmp / "ckpts"),
        "--log_dir", str(tmp / "logs"), "--exp_name", "t", "--device", "cpu",
    ]
    return tmp, flags, train_main(get_opts(flags))


def test_train_cli_on_two_ranks(trained):
    tmp, _, summaries = trained
    assert [s["rank"] for s in summaries] == [0, 1] and all(s["world"] == 2 for s in summaries)
    spe = math.ceil(5 / 2)  # the tiny LLFF scene's 5 items over a global batch of 2
    assert all(s["steps_per_epoch"] == spe and s["step"] == spe for s in summaries)
    assert summaries[0]["best_psnr"] == summaries[1]["best_psnr"] and np.isfinite(summaries[0]["best_psnr"])
    files = sorted(os.listdir(tmp / "ckpts" / "t"))
    assert files == ["epoch_0_psnr_%.2f.ckpt" % summaries[0]["best_psnr"], "last.ckpt"], files
    assert len(os.listdir(tmp / "logs" / "t")) == 1  # rank 0's event file alone
    blob = torch.load(tmp / "ckpts" / "t" / "last.ckpt", weights_only=False)
    assert tuple(blob["ref_feature"].shape) == (2, 384) and blob["ref_feature_valid"].tolist() == [True, True]
    assert not torch.equal(blob["ref_feature"][0], blob["ref_feature"][1])  # each rank's own item
    assert blob["global_step"] == spe


def test_resume_on_two_ranks_restores_each_ranks_rows(trained):
    tmp, flags, _ = trained
    ckpt = str(tmp / "ckpts" / "t" / "last.ckpt")
    blob = torch.load(ckpt, weights_only=False)
    hp = get_opts(flags[:flags.index("--num_epochs") + 1] + ["2"] + flags[flags.index("--num_epochs") + 2:]
                  + ["--ckpt_path", ckpt])
    ranks = ddp.launch(ddp_workers.resumed_rows, 2, "cpu", hp)
    for r, got in enumerate(ranks):
        assert torch.equal(got["ref_feature"], blob["ref_feature"][r:r + 1]), r
        assert got["ref_feature_valid"].tolist() == [True] and got["start_epoch"] == 1
        assert got["step"] == blob["global_step"]


def test_eval_cli_on_two_ranks_equals_one(trained, monkeypatch):
    tmp, flags, _ = trained
    root = flags[flags.index("--root_dir") + 1]
    monkeypatch.chdir(tmp)
    args = ["--root_dir", root, "--dataset_name", "llff", "--split", "val", "--img_wh", str(WH[0]), str(WH[1]),
            "--N_samples", "4", "--N_importance", "4", "--ckpt_path", str(tmp / "ckpts" / "t" / "last.ckpt"),
            "--device", "cpu", "--chunk", "256"]
    psnr = {n: port_eval.main(port_eval.get_opts(args + ["--num_gpus", str(n), "--timestamp", f"n{n}"]))
            for n in (1, 2)}
    assert np.isfinite(psnr[1]) and abs(psnr[2] - psnr[1]) < 0.01
    from PIL import Image

    out = tmp / "results" / "llff" / "test"
    names = sorted(os.listdir(out / "n1"))
    assert names == sorted(os.listdir(out / "n2")) and any(n.endswith(".png") for n in names)
    for name in (n for n in names if n.endswith(".png")):
        a, b = (np.asarray(Image.open(out / d / name), dtype=np.int16) for d in ("n1", "n2"))
        assert np.abs(a - b).max() <= 1, name
