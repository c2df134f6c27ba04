"""Eval CLI of the port: load a coarse+fine NeRF ``.ckpt``, render every pose
of the chosen split, write PNGs (+ optional depth as pfm/npy/png) and a GIF,
and print the mean PSNR over the poses with ground truth.

Counterpart of the JAX package's ``eval.py``, with the same flags plus
``--device``.  ``--mlp_impl pallas`` (the default) renders through the
hand-written CUDA kernels, ``--mlp_impl xla`` through the plain PyTorch path.

    python -m sinnerf_tpu_torch.eval --root_dir data/nerf_llff_data/room \
        --dataset_name llff --scene_name llff_room_s4 --img_wh 504 378 \
        --N_importance 64 --split val --ckpt_path ckpts/room.ckpt

``--num_gpus N`` renders each image's rays sharded over N cards, one
process each (JAX ``eval.py:139-161``); rank 0 writes the files.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser
from typing import Dict

import numpy as np
import torch

# the flags of the JAX eval.py (_EVAL_FLAGS, eval.py:25-58), plus --device
_EVAL_FLAGS = [
    ("root_dir", dict(type=str, required=True, help="root directory of dataset")),
    ("dataset_name", dict(type=str, default="blender_ray_patch_1image_rot3d",
                          choices=["llff", "blender_ray_patch_1image_rot3d",
                                   "dtu_proj", "llff_ray_patch_1image_proj",
                                   "blender_ray_patch_1image_proj"],
                          help="which dataset to validate")),
    ("scene_name", dict(type=str, default="test", help="output folder name")),
    ("split", dict(type=str, default="test", help="test / test_train / val")),
    ("img_wh", dict(nargs="+", type=int, default=[800, 800])),
    ("spheric_poses", dict(flag=True)),
    ("angle", dict(type=int, default=64)),
    ("N_samples", dict(type=int, default=64)),
    ("N_importance", dict(type=int, default=128)),
    ("use_disp", dict(flag=True)),
    ("chunk", dict(type=int, default=32 * 1024 * 4,
                   help="rays per render tile")),
    ("timestamp", dict(type=str, default="")),
    ("ckpt_path", dict(type=str, required=True,
                       help="reference-format torch .ckpt to load")),
    ("depth_type", dict(type=str, default="nerf")),
    ("save_depth", dict(flag=True)),
    ("depth_format", dict(type=str, default="pfm",
                          choices=["pfm", "bytes", "npy", "png"])),
    ("model", dict(type=str, default="nerf", choices=["nerf", "nerf_ft"])),
    ("scan", dict(type=int, default=4)),
    ("compute_dtype", dict(type=str, default="float32",
                           choices=["float32", "bfloat16"])),
    ("mlp_impl", dict(type=str, default="pallas", choices=["xla", "pallas"],
                      help="pallas: hand-written CUDA kernels; xla: plain PyTorch")),
    ("ref_idx", dict(type=int, default=None,
                     help="override the blender reference-frame index")),
    ("num_gpus", dict(type=int, default=1,
                      help="cards to render each image over, one process each "
                           "(with --device cpu: gloo processes)")),
    ("device", dict(type=str, default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default) or, when asked, the CPU")),
]


def get_opts(args=None):
    parser = ArgumentParser()
    for name, spec in _EVAL_FLAGS:
        spec = dict(spec)
        if spec.pop("flag", False):
            parser.add_argument(f"--{name}", default=False, action="store_true")
        else:
            parser.add_argument(f"--{name}", **spec)
    return parser.parse_args(args)


def load_models(ckpt_path: str, device: torch.device) -> Dict[str, "torch.nn.Module"]:
    """The coarse/fine ``NeRF`` modules of a reference-format ``.ckpt``."""
    from sinnerf_tpu_torch.models.nerf import nerf_from_state
    from sinnerf_tpu_torch.train.checkpoints import load_torch_nerf_checkpoint

    if os.path.isdir(ckpt_path):
        raise ValueError(
            f"{ckpt_path} is a directory: the port reads reference-format .ckpt "
            "files only, not orbax checkpoint directories (the JAX package's "
            "`save_weights_only --torch` converts those)"
        )
    states = load_torch_nerf_checkpoint(ckpt_path)
    return {name: nerf_from_state(sd).to(device).eval() for name, sd in states.items()}


def _write_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img).save(path)


def _write_gif(path: str, imgs, fps: int = 5) -> None:
    """The renders as a looping GIF, ``fps`` frames per second (PIL: the
    port does not need imageio)."""
    from PIL import Image

    frames = [Image.fromarray(im) for im in imgs]
    if frames:
        frames[0].save(path, save_all=True, append_images=frames[1:], duration=int(1000 / fps), loop=0)


def main(args):
    """Render the split on ``--num_gpus`` ranks (in this process on one);
    returns the mean PSNR, or None without ground truth."""
    from sinnerf_tpu_torch.parallel import ddp
    from sinnerf_tpu_torch.utils.device import resolve_device

    world = ddp.world_for(args.num_gpus, args.device)
    if world == 1 and ddp.torchrun_env() is None:
        return run(0, 1, args)
    return ddp.launch(run, world, resolve_device(args.device).type, args)[0]


def run(rank: int, world: int, args):
    """Rank ``rank`` of ``world``: every rank renders its slab of each
    image and gets the whole image; rank 0 writes the PNGs, depth files and
    GIF and prints the mean PSNR."""
    from sinnerf_tpu_torch.data.depth_io import save_pfm
    from sinnerf_tpu_torch.data import dataset_dict
    from sinnerf_tpu_torch.parallel import ddp
    from sinnerf_tpu_torch.render.renderer import RenderSettings, pick_val_tile, render_chunked, render_chunked_sharded
    from sinnerf_tpu_torch.utils.device import resolve_device
    from sinnerf_tpu_torch.utils.visualization import visualize_depth

    device = ddp.rank_device(resolve_device(args.device).type)
    write = rank == 0
    if args.timestamp == "":
        parts = args.ckpt_path.split('/')
        args.timestamp = parts[1] if len(parts) > 1 else 'ckpt'

    w, h = args.img_wh
    kwargs = dict(vars(args))
    kwargs["img_wh"] = tuple(args.img_wh)
    root = kwargs.pop("root_dir")
    split = kwargs.pop("split")
    dataset = dataset_dict[args.dataset_name](root, split=split, **kwargs)

    models = load_models(args.ckpt_path, device)
    settings = RenderSettings(
        n_samples=args.N_samples,
        n_importance=args.N_importance,
        use_disp=args.use_disp,
        perturb=0.0,
        noise_std=0.0,
        white_back=dataset.white_back,
        compute_dtype=args.compute_dtype,
        mlp_impl=args.mlp_impl,
    )

    dir_name = f'results/{args.dataset_name}/{args.scene_name}/{args.timestamp}'
    if write:
        os.makedirs(dir_name, exist_ok=True)
    tile = pick_val_tile(w * h, args.chunk, world)

    imgs, psnrs = [], []
    for i in range(dataset.val_len()):
        sample = dataset.val_item(i)
        rays = torch.from_numpy(sample["rays"]).to(device)
        if world > 1:
            results = render_chunked_sharded(models, rays, settings, rank, world, tile=tile,
                                             keys=("rgb_fine", "depth_fine"))
        else:
            results = render_chunked(models, rays, settings, tile=tile)
        img_pred = results["rgb_fine"].cpu().numpy().reshape(h, w, 3)
        if "fname" in sample:
            # exact reference formula: only .JPG is stripped (eval.py:164)
            fname = os.path.basename(sample["fname"]).replace('.JPG', '')
        else:
            fname = f'{i:03d}'

        if args.save_depth and write:
            depth_pred = np.nan_to_num(results["depth_fine"].cpu().numpy().reshape(h, w))
            if args.depth_format == 'pfm':
                save_pfm(os.path.join(dir_name, f'depth_{fname}.pfm'), depth_pred)
            elif args.depth_format == 'npy':
                np.save(os.path.join(dir_name, f'{fname}.npy'), depth_pred)
            else:
                depth_img = (visualize_depth(depth_pred).transpose(1, 2, 0) * 255).astype(np.uint8)
                _write_png(os.path.join(dir_name, f'{fname}_depth.png'), depth_img)

        img_pred_ = (np.clip(img_pred, 0, 1) * 255).astype(np.uint8)
        imgs.append(img_pred_)
        if write:
            _write_png(os.path.join(dir_name, f'{fname}.png'), img_pred_)

        if "rgbs" in sample:
            img_gt = np.asarray(sample["rgbs"]).reshape(h, w, 3)
            mse = np.mean((img_pred - img_gt) ** 2)
            psnrs.append(float(-10.0 * np.log10(mse)))

    if write:
        _write_gif(os.path.join(dir_name, f'{args.scene_name}.gif'), imgs, fps=5)

    if psnrs:
        mean_psnr = float(np.mean(psnrs))
        if write:
            print(f'Mean PSNR : {mean_psnr:.2f}')
        return mean_psnr
    return None


if __name__ == "__main__":
    main(get_opts())
