#!/usr/bin/env python3
"""Deterministic training (``--perturb 0 --noise_std 0``) on the LLFF
training set: does the render turn black in the PyTorch port only, or in the
method as the JAX package trains it too?

    JAX_PLATFORMS=cpu python scripts/det_training_witness.py cpu
    python scripts/det_training_witness.py cuda

``cpu`` trains the JAX package's ``SinNeRFTrainer`` and the port's side by
side on a small synthetic LLFF scene (64x48, 16 + 16 samples, float32, the
plain paths), from the same initial weights (the JAX trainer's, converted):
first for several seeds, each trainer with its own sampler draws; then for
two of them with the JAX trainer's batches fed to both, so that the two runs
differ only by rounding.  ``cuda`` runs the port's trainer (what the train
CLI's ``main`` runs) on one card at
the full size of ``chip_smoke.py`` (504x378, 64 + 128 samples) from the
random weights, on the kernels and on the plain path (``--mlp_impl xla``)
with the same batches.  Both print the val PSNR after each epoch and what a
black render scores on the same val images.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CPU_WH = (64, 48)
CPU_SEEDS = 6
CPU_SHARED_SEEDS = (0, 3)  # one whose JAX run stays lit, one whose JAX run turns black
CPU_EPOCHS = 3
CUDA_EPOCHS = 2
DET = ["--perturb", "0", "--noise_std", "0"]


def cpu_flags(root: str, workdir: str, seed: int):
    w, h = CPU_WH
    return [
        "--dataset_name", "llff_ray_patch_1image_proj", "--root_dir", root, "--img_wh", str(w), str(h),
        "--N_samples", "16", "--N_importance", "16", "--num_rays", "256", "--patch_size_x", "8",
        "--patch_size_y", "8", "--sW", "2", "--sH", "2", "--batch_size", "1", "--num_gpus", "1",
        "--dis_weight", "0", "--load_depth", "--depth_weight", "8", "--proj_weight", "1",
        "--depth_smooth_weight", "0.5", "--num_epochs", str(CPU_EPOCHS), "--check_val_every_n_epoch", "1",
        "--ckpt_dir", os.path.join(workdir, "ckpts"), "--log_dir", os.path.join(workdir, "logs"),
        "--exp_name", f"seed{seed}", "--compute_dtype", "float32", "--mlp_impl", "xla", "--seed", str(seed), *DET,
    ]


def twin_trainers(root: str, workdir: str, seed: int):
    """The JAX trainer and the port's on the same flags, the port holding
    the JAX trainer's initial weights."""
    import opt as jax_opt
    from sinnerf_tpu.train.loop import SinNeRFTrainer as JaxTrainer

    from sinnerf_tpu_torch.models.nerf import state_dict_from_jax
    from sinnerf_tpu_torch.opt import get_opts
    from sinnerf_tpu_torch.train.loop import SinNeRFTrainer

    flags = cpu_flags(root, workdir, seed)
    jax_trainer = JaxTrainer(jax_opt.get_opts(flags))
    port = SinNeRFTrainer(get_opts(flags + ["--device", "cpu"]))
    for level, model in port.state.models.items():
        model.load_state_dict(state_dict_from_jax(
            {k: {n: np.asarray(a) for n, a in v.items()} for k, v in jax_trainer.state.params[level].items()}))
    return jax_trainer, port


def share_jax_batches(jax_trainer, port) -> None:
    """Feed the port's trainer the batches the JAX trainer draws, in order
    (the JAX epoch runs first)."""
    import torch

    queue = []
    draw = jax_trainer._epoch_batches

    def recording(epoch, spe):
        for i, batch, key in draw(epoch, spe):
            queue.append({k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
            yield i, batch, key

    jax_trainer._epoch_batches = recording
    port.train_dataset.sample = lambda step, batch_size, generator, draws=None: queue.pop(0)


def cpu_main() -> int:
    import torch

    import chip_smoke
    from sinnerf_tpu_torch.data.synthetic import make_llff_scene

    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as workdir:
        root = make_llff_scene(os.path.join(workdir, "llff"), CPU_WH)
        empty = None
        for seed, shared in [(s, False) for s in range(CPU_SEEDS)] + [(s, True) for s in CPU_SHARED_SEEDS]:
            jax_trainer, port = twin_trainers(root, workdir, seed)
            if empty is None:
                empty = chip_smoke.empty_render_psnr(port.val_dataset)
                print(f"black render: val PSNR {empty:.4f}")
            if shared:
                share_jax_batches(jax_trainer, port)
            rows = [("init", jax_trainer.validate(0, log=False), port.validate(0, log=False))]
            host_step = 0
            for epoch in range(CPU_EPOCHS):
                host_step = jax_trainer._run_epoch(epoch, jax_trainer.steps_per_epoch(), host_step)
                port._run_epoch(epoch, port.steps_per_epoch())
                rows.append((epoch, jax_trainer.validate(epoch, log=False), port.validate(epoch, log=False)))
            what = "the JAX trainer's batches fed to both" if shared else "each trainer its own draws"
            print(f"seed {seed}, {what}: val PSNR (epoch, JAX, port) "
                  + ", ".join(f"({e}, {j:.4f}, {p:.4f})" for e, j, p in rows), flush=True)
    return 0


def cuda_main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("det_training_witness: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke
    from sinnerf_tpu_torch.data.synthetic import make_llff_scene
    from sinnerf_tpu_torch.opt import get_opts
    from sinnerf_tpu_torch.train.loop import SinNeRFTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card_line())
    with tempfile.TemporaryDirectory() as workdir:
        root = make_llff_scene(os.path.join(workdir, "llff"), chip_smoke.IMG_WH)
        for cd in ("float32", "bfloat16"):
            for impl in ("pallas", "xla"):
                exp = f"witness_{cd}_{impl}"
                flags = chip_smoke.cli_flags(root, workdir, cd, exp) + DET + [
                    "--mlp_impl", impl, "--num_epochs", str(CUDA_EPOCHS)]
                trainer = SinNeRFTrainer(get_opts(flags))
                init = trainer.validate(0, log=False)
                trainer.fit()
                empty = chip_smoke.empty_render_psnr(trainer.val_dataset)
                print(f"random init, {cd}, mlp_impl={impl}: val PSNR at init {init:.4f}, per epoch "
                      f"{trainer.val_log} (black render {empty:.4f})", flush=True)
                del trainer
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2 or sys.argv[1] not in ("cpu", "cuda"):
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(cpu_main() if sys.argv[1] == "cpu" else cuda_main())
