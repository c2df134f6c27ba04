"""The port's train CLI: flags, trainer, checkpoints, resume, against the JAX
package where the two can be compared.

The flag table of ``sinnerf_tpu_torch/opt.py`` is held equal to root
``opt.py``'s (names, types, defaults, choices; the port adds ``--device``).
``SinNeRFTrainer.validate`` on the JAX trainer's initial weights, converted,
gives the JAX trainer's val PSNR on the same synthetic LLFF scene (rtol
1e-4: the same renders, summed in other orders; the kernel path's plain
versions on the CPU against JAX's interpret-mode kernels).  A tiny run of
``python -m sinnerf_tpu_torch.train --device cpu`` writes the top-2 and
``last`` checkpoints, resumes from ``last`` for another epoch, and the eval
CLI reads its checkpoint.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WH = (32, 24)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite's workers share the machine's cores; more torch threads per
    worker only make them wait on each other (on 8 cores in 6 workers, a
    7 s test took 330 s at 8 threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flags(root, tmp, *extra):
    return [
        "--dataset_name", "llff_ray_patch_1image_proj", "--root_dir", root, "--img_wh", str(WH[0]), str(WH[1]),
        "--N_samples", "4", "--N_importance", "4", "--num_rays", "32", "--patch_size_x", "8", "--patch_size_y",
        "8", "--sW", "2", "--sH", "2", "--batch_size", "1", "--num_gpus", "1", "--dis_weight", "0",
        "--load_depth", "--depth_weight", "8", "--proj_weight", "1", "--depth_smooth_weight", "0.5",
        "--num_epochs", "2", "--check_val_every_n_epoch", "1", "--ckpt_dir", os.path.join(tmp, "ckpts"),
        "--log_dir", os.path.join(tmp, "logs"), "--exp_name", "t", "--device", "cpu", *extra,
    ]


@pytest.fixture(scope="module")
def llff_root(tmp_path_factory):
    from sinnerf_tpu_torch.data.synthetic import make_llff_scene

    return make_llff_scene(str(tmp_path_factory.mktemp("llff")), WH)


def test_flag_tables_are_equal():
    import opt as jax_opt

    from sinnerf_tpu_torch import opt as port_opt

    def table(spec):
        return {name: {k: v for k, v in kw.items() if k != "help"} for name, kw in spec}

    jax_t, port_t = table(jax_opt._FLAG_SPEC), table(port_opt._FLAG_SPEC)
    assert set(port_t) - set(jax_t) == {"device"}
    for name, kw in jax_t.items():
        assert port_t[name] == kw, name
    assert port_opt.get_opts([]).device == "cuda"
    assert port_opt.get_opts(["--device", "cpu"]).device == "cpu"


def test_validate_on_converted_weights_gives_jax_psnr(llff_root, tmp_path):
    """The JAX trainer's val PSNR at its initial weights, and the port's
    trainer's on the same weights converted, kernel path (float32)."""
    import opt as jax_opt
    from sinnerf_tpu.train.loop import SinNeRFTrainer as JaxTrainer
    from sinnerf_tpu_torch.models.nerf import state_dict_from_jax
    from sinnerf_tpu_torch.opt import get_opts
    from sinnerf_tpu_torch.train.loop import SinNeRFTrainer

    flags = _flags(llff_root, str(tmp_path), "--compute_dtype", "float32", "--mlp_impl", "pallas")
    port = SinNeRFTrainer(get_opts(flags))
    hp = jax_opt.get_opts([f for f in flags if f not in ("--device", "cpu")])
    jax_trainer = JaxTrainer(hp)
    for level, model in port.state.models.items():
        model.load_state_dict(state_dict_from_jax(
            {k: {n: np.asarray(a) for n, a in v.items()} for k, v in jax_trainer.state.params[level].items()}))
    want = jax_trainer.validate(0, log=False)
    got = port.validate(0, log=False)
    assert port.val_dataset.val_len() == 5
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_cli_trains_checkpoints_resumes_and_evals(llff_root, tmp_path):
    """``python -m sinnerf_tpu_torch.train`` on the CPU, deterministic
    flags; then a resume from ``last.ckpt`` (weights and Adam state restored
    exactly) for a third epoch, in process; then the eval CLI on the best
    checkpoint."""
    from sinnerf_tpu_torch import eval as port_eval
    from sinnerf_tpu_torch.opt import get_opts
    from sinnerf_tpu_torch.train.__main__ import main
    from sinnerf_tpu_torch.train.checkpoints import load_torch_nerf_checkpoint
    from sinnerf_tpu_torch.train.loop import SinNeRFTrainer

    flags = _flags(llff_root, str(tmp_path), "--perturb", "0", "--noise_std", "0")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    run = subprocess.run([sys.executable, "-m", "sinnerf_tpu_torch.train", *flags], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "best val/psnr:" in run.stdout
    ckpt_dir = tmp_path / "ckpts" / "t"
    files = sorted(os.listdir(ckpt_dir))
    assert "last.ckpt" in files and sum(f.startswith("epoch_") for f in files) == 2, files
    blob = torch.load(ckpt_dir / "last.ckpt", weights_only=False)
    assert blob["epoch"] == 1 and blob["global_step"] == 10 and len(blob["ckpt_best"]) == 2
    assert blob["optimizer_states"][0]["state"]  # Adam's moments

    resume_flags = (flags[:flags.index("--num_epochs") + 1] + ["3"] + flags[flags.index("--num_epochs") + 2:]
                    + ["--ckpt_path", str(ckpt_dir / "last.ckpt")])
    # a resumed trainer holds the saved weights and Adam state bit for bit
    restored = SinNeRFTrainer(get_opts(resume_flags))
    saved = load_torch_nerf_checkpoint(str(ckpt_dir / "last.ckpt"))
    for level, model in restored.state.models.items():
        for name, value in model.state_dict().items():
            assert torch.equal(value, saved[level][name]), (level, name)
    saved_opt = blob["optimizer_states"][0]["state"]
    got_opt = restored.state.opt_g.state_dict()["state"]
    assert got_opt.keys() == saved_opt.keys()
    for i, moments in saved_opt.items():
        for key, value in moments.items():
            assert torch.equal(torch.as_tensor(got_opt[i][key]), torch.as_tensor(value)), (i, key)
    del restored

    trainer = main(get_opts(resume_flags))
    assert trainer.start_epoch == 2 and [e[0] for e in trainer.epoch_log] == [2]
    assert trainer.state.step == 15
    assert len(trainer.ckpt_manager.best) == 2
    step = next(iter(trainer.state.opt_g.state.values()))["step"]
    assert float(step) == 15  # the moments and Adam's step carried over

    best = [f for f in os.listdir(ckpt_dir) if f.startswith("epoch_")][0]
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        psnr = port_eval.main(port_eval.get_opts([
            "--root_dir", llff_root, "--dataset_name", "llff", "--split", "val", "--img_wh", str(WH[0]), str(WH[1]),
            "--N_samples", "4", "--N_importance", "4", "--ckpt_path", str(ckpt_dir / best), "--device", "cpu"]))
    finally:
        os.chdir(cwd)
    assert np.isfinite(psnr)


def test_warm_start_ignores_prefixes(llff_root, tmp_path):
    """``--pt_model`` loads a reference-format checkpoint's NeRFs; keys under
    ``--prefixes_to_ignore`` are dropped first."""
    from sinnerf_tpu_torch.models.nerf import random_params, state_dict_from_jax
    from sinnerf_tpu_torch.opt import get_opts
    from sinnerf_tpu_torch.train.checkpoints import save_torch_nerf_checkpoint
    from sinnerf_tpu_torch.train.loop import SinNeRFTrainer

    rng = np.random.default_rng(5)
    states = {"coarse": state_dict_from_jax(random_params(rng)), "fine": state_dict_from_jax(random_params(rng))}
    pt = save_torch_nerf_checkpoint(str(tmp_path / "pt.ckpt"), states)
    plain = SinNeRFTrainer(get_opts(_flags(llff_root, str(tmp_path))))
    warm = SinNeRFTrainer(get_opts(_flags(llff_root, str(tmp_path), "--pt_model", pt, "--prefixes_to_ignore",
                                          "nerf_fine")))
    key = "sigma.weight"
    torch.testing.assert_close(warm.state.models["coarse"].state_dict()[key], states["coarse"][key])
    torch.testing.assert_close(warm.state.models["fine"].state_dict()[key], plain.state.models["fine"].state_dict()[key])


def test_top_k_manager_keeps_the_best_two_and_last(tmp_path):
    from sinnerf_tpu_torch.train.checkpoints import TopKCheckpointManager

    m = TopKCheckpointManager(str(tmp_path), top_k=2)
    for epoch, score in enumerate([10.0, float("nan"), 12.0, 11.0, 9.0]):
        m.save({"state_dict": {}, "epoch": epoch}, epoch, score)
    assert sorted(os.listdir(tmp_path)) == ["epoch_2_psnr_12.00.ckpt", "epoch_3_psnr_11.00.ckpt", "last.ckpt"]
    assert [p for p, _ in m.best] == [12.0, 11.0]
    again = TopKCheckpointManager(str(tmp_path), top_k=2, best=[[12.0, "epoch_2_psnr_12.00.ckpt"], [5.0, "gone.ckpt"]])
    assert again.best == [(12.0, "epoch_2_psnr_12.00.ckpt")]


@pytest.mark.parametrize("extra", [["--num_gpus", "2"], ["--vit_weight", "10"], ["--dis_weight", "0.01"],
                                   ["--dataset_name", "blender_ray_patch_1image_rot3d"]])
def test_later_slices_raise(llff_root, tmp_path, extra):
    """Multi-GPU training and the Blender set are later slices.  The Step-2
    extras are built (tests/test_torch_step2.py), but refused where the JAX
    trainer refuses them or cannot run them: the ViT without
    ``--vit_weights`` or ``--allow_random_pretrained``, and the
    discriminator on these 8-pixel patches, too small for its 16 branch."""
    from sinnerf_tpu_torch.opt import get_opts
    from sinnerf_tpu_torch.train.loop import SinNeRFTrainer

    later = extra[0] in ("--num_gpus", "--dataset_name")
    with pytest.raises(NotImplementedError if later else ValueError):
        SinNeRFTrainer(get_opts(_flags(llff_root, str(tmp_path)) + extra))


def test_cuda_is_the_default_and_refused_without_a_card(llff_root, tmp_path, monkeypatch):
    from sinnerf_tpu_torch.opt import get_opts
    from sinnerf_tpu_torch.train.loop import SinNeRFTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flags = _flags(llff_root, str(tmp_path))
    flags = flags[:flags.index("--device")]
    with pytest.raises(RuntimeError):
        SinNeRFTrainer(get_opts(flags))


def test_epoch_learning_rate_follows_the_schedule(llff_root, tmp_path):
    from sinnerf_tpu_torch.opt import get_opts
    from sinnerf_tpu_torch.train.loop import SinNeRFTrainer
    from sinnerf_tpu_torch.train.optimizers import lr_for_epoch

    hp = get_opts(_flags(llff_root, str(tmp_path), "--lr", "1e-3", "--decay_step", "1", "--decay_gamma", "0.5"))
    trainer = SinNeRFTrainer(hp)
    trainer.train_dataset.length = 1
    for epoch in (0, 1):
        trainer._run_epoch(epoch, trainer.steps_per_epoch())
        assert trainer.state.opt_g.param_groups[0]["lr"] == pytest.approx(lr_for_epoch(hp, epoch))
    assert trainer.state.opt_g.param_groups[0]["lr"] == pytest.approx(5e-4)
    assert trainer.state.step == 2 and isinstance(hp, argparse.Namespace)
