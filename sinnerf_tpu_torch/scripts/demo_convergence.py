"""End-to-end convergence demo on a procedurally generated Blender scene.

Counterpart of ``scripts/demo_convergence.py``: the training stack of the
train CLI (``BlenderRot3D``'s sampler, ``train_step`` with the Step-1
weights: depth 8, smoothness 0.5, projection 1) for a few hundred steps on
``make_blender_scene``'s disk at realistic render settings (64 + 64
samples), with the val PSNR before and after, which must rise by more than
3 dB.  By default it runs on the card, on the CUDA kernels
(``--mlp_impl pallas``) in bfloat16; its sampler and render draws come from
generators of its own, seeded by ``--seed``.

    python -m sinnerf_tpu_torch.scripts.demo_convergence [--steps 300] [--img 128] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict


def get_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--img", type=int, default=128)
    ap.add_argument("--patch", type=int, default=32)
    ap.add_argument("--n_samples", type=int, default=64)
    ap.add_argument("--n_importance", type=int, default=64)
    ap.add_argument("--num_rays", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--mlp_impl", default="pallas", choices=["xla", "pallas"],
                    help="pallas: the hand-written CUDA kernels; xla: plain PyTorch")
    ap.add_argument("--compute_dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default) or, when asked, the CPU")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, workdir: str) -> Dict[str, float]:
    import torch

    from sinnerf_tpu_torch.data.synthetic import make_blender_scene
    from sinnerf_tpu_torch.opt import get_opts
    from sinnerf_tpu_torch.train.loop import SinNeRFTrainer
    from sinnerf_tpu_torch.train.step import train_step

    root = make_blender_scene(os.path.join(workdir, "scene"), (args.img, args.img))
    hparams = get_opts([
        "--root_dir", root, "--dataset_name", "blender_ray_patch_1image_rot3d",
        "--img_wh", str(args.img), str(args.img), "--N_samples", str(args.n_samples),
        "--N_importance", str(args.n_importance), "--batch_size", "1", "--num_epochs", "1", "--num_gpus", "1",
        "--lr", str(args.lr), "--decay_step", str(10 ** 9), "--decay_gamma", "0.5", "--exp_name", "demo",
        "--with_ref", "--patch_size", str(args.patch), "--sW", "2", "--sH", "2", "--load_depth",
        "--dis_weight", "0", "--proj_weight", "1", "--depth_weight", "8", "--depth_smooth_weight", "0.5",
        "--compute_dtype", args.compute_dtype, "--mlp_impl", args.mlp_impl, "--check_val_every_n_epoch", "1",
        "--ckpt_dir", os.path.join(workdir, "ckpts"), "--log_dir", os.path.join(workdir, "logs"),
        "--seed", str(args.seed), "--num_rays", str(args.num_rays), "--ref_idx", "0", "--device", args.device,
    ])
    trainer = SinNeRFTrainer(hparams)
    device = trainer.device

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    psnr0 = trainer.validate(0, log=False)
    print(f"val PSNR before training: {psnr0:.2f} dB", flush=True)
    sample_gen = torch.Generator().manual_seed(args.seed + 11)
    render_gen = torch.Generator(device=device).manual_seed(args.seed + 12)
    t_first = time.perf_counter()
    for i in range(args.steps):
        batch = trainer.train_dataset.sample(i, 1, sample_gen)
        trainer.state, out = train_step(trainer.state, batch, trainer.cfg, 0.0, generator=render_gen)
        if i == 0:  # the first step apart (a fresh process builds the kernels there)
            sync()
            t_steady = time.perf_counter()
            print(f"first step: {t_steady - t_first:.1f} s", flush=True)
        if (i + 1) % 50 == 0:
            m = out["metrics"]
            print(f"step {i + 1}: loss={float(m['train/loss']):.4f} train_psnr={float(m['train/psnr']):.2f}",
                  flush=True)
    sync()
    steps_per_s = (args.steps - 1) / max(time.perf_counter() - t_steady, 1e-9)
    print(f"throughput: {steps_per_s:.2f} steps/s", flush=True)
    psnr1 = trainer.validate(0, log=False)
    print(f"val PSNR after {args.steps} steps: {psnr1:.2f} dB (was {psnr0:.2f})", flush=True)
    if not psnr1 > psnr0 + 3:
        raise AssertionError(f"training did not converge: val PSNR {psnr0:.2f} -> {psnr1:.2f} dB")
    print("CONVERGENCE OK", flush=True)
    return {"psnr_before": psnr0, "psnr_after": psnr1, "steps_per_s": steps_per_s, "steps": args.steps}


def main(argv=None) -> Dict[str, float]:
    """Run the demo on ``argv``'s flags in a temporary directory; returns the
    val PSNR before and after and the steps per second.  Raises
    AssertionError when the PSNR does not rise by more than 3 dB."""
    args = get_args(argv)
    with tempfile.TemporaryDirectory(prefix="sinnerf_demo_") as tmp:
        return run(args, tmp)


if __name__ == "__main__":
    main()
