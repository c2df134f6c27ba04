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
val PSNR.  ``--num_gpus N`` trains on N cards, one process each (NCCL), with
``--batch_size`` items per card; with ``--device cpu`` it runs N gloo
processes.  Under ``torchrun --nproc_per_node N`` each process is one rank.
"""

from __future__ import annotations

from typing import Any, Dict, List, Union

from sinnerf_tpu_torch.opt import get_opts
from sinnerf_tpu_torch.parallel import ddp
from sinnerf_tpu_torch.train.loop import SinNeRFTrainer, run, run_rank
from sinnerf_tpu_torch.utils.device import resolve_device


def main(hparams) -> Union[SinNeRFTrainer, List[Dict[str, Any]]]:
    """Train with ``hparams`` on ``--num_gpus`` ranks.  On one, in this
    process: returns the trainer.  On several, one process each: returns
    the ranks' ``loop.summary`` in rank order."""
    world = ddp.world_for(hparams.num_gpus, hparams.device)
    if world == 1 and ddp.torchrun_env() is None:
        return run(0, 1, hparams)
    return ddp.launch(run_rank, world, resolve_device(hparams.device).type, hparams)


if __name__ == "__main__":
    main(get_opts())
