"""The port's train CLI, counterpart of root ``train.py``:

    python -m sinnerf_tpu_torch.train --dataset_name llff_ray_patch_1image_proj \
        --root_dir data/nerf_llff_data/room --img_wh 504 378 \
        --patch_size_x 63 --patch_size_y 84 --sW 6 --sH 6 \
        --N_samples 64 --N_importance 128 --num_epochs 2000 --batch_size 1 \
        --optimizer adam --lr 2e-4 --lr_scheduler steplr --decay_step 500 1000 \
        --decay_gamma 0.5 --exp_name room_s4 --proj_weight 1 \
        --depth_smooth_weight 0.5 --dis_weight 0 --num_gpus 1 --load_depth \
        --depth_type nerf --model sinnerf --depth_weight 8

It runs on the card unless ``--device cpu`` is given, writes checkpoints
under ``--ckpt_dir/--exp_name`` (top-2 on val/psnr and ``last.ckpt``, which
the port's eval CLI reads and ``--ckpt_path`` resumes) and prints the best
val PSNR.
"""

from __future__ import annotations

from sinnerf_tpu_torch.opt import get_opts
from sinnerf_tpu_torch.train.loop import SinNeRFTrainer


def main(hparams) -> SinNeRFTrainer:
    """Train with ``hparams``; returns the trainer after its fit, with the
    best val PSNR in ``trainer.best_psnr``."""
    trainer = SinNeRFTrainer(hparams)
    trainer.best_psnr = trainer.fit()
    print(f"best val/psnr: {trainer.best_psnr:.3f}")
    return trainer


if __name__ == "__main__":
    main(get_opts())
