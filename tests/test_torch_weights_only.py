"""The weights-only tool (``sinnerf_tpu_torch/utils/save_weights_only.py``)
on a training checkpoint of one epoch of the train CLI on a DTU scene with
the PatchGAN, against the JAX package's ``export_torch_checkpoint`` on the
same weights (same keys, shapes and values; ``weight_v``, recomputed from
``W`` and ``u`` by a float32 sum on each side, within 1e-6 of its largest
entry); the stripped file warm-starts the trainer and renders the full
checkpoint's PSNR in the eval CLI.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sinnerf_tpu_torch import eval as port_eval  # noqa: E402
from sinnerf_tpu_torch.data.synthetic import make_dtu_scene_rich  # noqa: E402
from sinnerf_tpu_torch.opt import get_opts  # noqa: E402
from sinnerf_tpu_torch.train.__main__ import main as train_main  # noqa: E402
from sinnerf_tpu_torch.train.loop import SinNeRFTrainer  # noqa: E402
from test_torch_blender_dtu_cli import DTU_WH, _flags, _two_torch_threads  # noqa: E402,F401


@pytest.fixture(scope="module")
def dtu_run(tmp_path_factory):
    """(the DTU scene's root, the best checkpoint of one epoch of the train
    CLI with D)."""
    root = make_dtu_scene_rich(str(tmp_path_factory.mktemp("scenes") / "dtu"), DTU_WH, n_src=3)
    tmp = str(tmp_path_factory.mktemp("dtu"))
    train_main(get_opts(_flags("dtu", root, tmp)))
    ckpt_dir = os.path.join(tmp, "ckpts", "dtu")
    best = [f for f in os.listdir(ckpt_dir) if f.startswith("epoch_")]
    assert len(best) == 1
    return root, os.path.join(ckpt_dir, best[0])


def test_weights_only_matches_export_and_loads(dtu_run, tmp_path, monkeypatch):
    """The port's tool on a training checkpoint with a discriminator, and
    the JAX package's ``export_torch_checkpoint`` on the same weights: the
    same keys, shapes and values.  The stripped file warm-starts the trainer
    (``--pt_model``) with those weights and gives the eval CLI the full
    checkpoint's PSNR."""
    import jax

    from sinnerf_tpu.train import checkpoints as jax_checkpoints
    from sinnerf_tpu_torch.train.checkpoints import load_torch_nerf_checkpoint as port_load
    from sinnerf_tpu_torch.utils.save_weights_only import main as strip

    root, ckpt = dtu_run
    out = strip([ckpt, str(tmp_path / "weights.ckpt")])
    got = torch.load(out, weights_only=False)
    weights = jax_checkpoints.load_torch_nerf_checkpoint(ckpt, nerf_only=False)  # the JAX package's reading of them
    tree = {"state": {"params": {k: weights[k] for k in ("coarse", "fine")}, "d_params": weights["d_params"],
                      "sn_state": weights["sn_state"]}, "epoch": 0, "hparams": {"patch_size": 16}}
    # the tree as its orbax checkpoint restores it (host arrays), without the round trip
    monkeypatch.setattr(jax_checkpoints, "load_checkpoint", lambda path: jax.tree_util.tree_map(np.array, tree))
    want = torch.load(jax_checkpoints.export_torch_checkpoint("full", str(tmp_path / "export.ckpt")),
                      weights_only=False)
    assert set(got) == set(want) == {"state_dict", "epoch"}
    assert set(got["state_dict"]) == set(want["state_dict"])
    assert any(k.startswith("D.main.") for k in got["state_dict"])
    for k, v in want["state_dict"].items():
        assert got["state_dict"][k].shape == v.shape and got["state_dict"][k].dtype == v.dtype, k
        # weight_v = normalize(W^T u) is a float32 sum taken in another order
        # on each side (measured 7.5e-8 at an entry of 0.36); the rest is exact
        atol = 1e-6 * float(v.abs().max()) if k.endswith("weight_v") else 0.0
        torch.testing.assert_close(got["state_dict"][k], v, rtol=0, atol=atol, msg=k)
    full = torch.load(ckpt, weights_only=False)["state_dict"]
    assert all(torch.equal(got["state_dict"][k], full[k]) for k in got["state_dict"])

    warm = SinNeRFTrainer(get_opts(_flags("dtu", root, str(tmp_path), "--pt_model", out)))
    for level, sd in port_load(ckpt).items():
        for key, value in warm.state.models[level].state_dict().items():
            assert torch.equal(value, sd[key]), (level, key)
    monkeypatch.chdir(tmp_path)
    psnrs = [port_eval.main(port_eval.get_opts([
        "--root_dir", root, "--dataset_name", "dtu_proj", "--split", "val", "--img_wh", *map(str, DTU_WH),
        "--N_samples", "4", "--N_importance", "4", "--ckpt_path", path, "--scene_name", tag, "--device", "cpu"]))
        for tag, path in (("full", ckpt), ("weights", out))]
    assert psnrs[0] == psnrs[1]
