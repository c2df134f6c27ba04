"""Command-line flags of the port's train CLI.

The port's own copy of root ``opt.py``'s flag table (``_FLAG_SPEC`` and
``build_parser``, :126), which the port does not import: the reference's
names, defaults and choices (``opt.py:4-124``), the JAX package's extras,
and ``--device``.  ``tests/test_torch_trainer.py`` holds the two tables
equal.
"""

import argparse

# (name, kwargs) — a None default with 'flag': True means store_true.
_FLAG_SPEC = [
    # data ------------------------------------------------------------------
    ("root_dir", dict(type=str, default="data/nerf_synthetic/lego",
                      help="root directory of dataset")),
    ("dataset_name", dict(type=str, default="blender",
                          choices=["llff_ray_patch_1image_proj",
                                   "blender_ray_patch_1image_proj",
                                   "blender_ray_patch_1image_rot3d",
                                   "dtu_proj"],
                          help="which dataset to train/val")),
    ("img_wh", dict(nargs="+", type=int, default=[800, 800],
                    help="resolution (img_w, img_h) of the image")),
    ("spheric_poses", dict(flag=True, help="spheric capture (for llff)")),
    # sampling ---------------------------------------------------------------
    ("N_samples", dict(type=int, default=64, help="number of coarse samples")),
    ("N_importance", dict(type=int, default=128,
                          help="number of additional fine samples")),
    ("use_disp", dict(flag=True, help="use disparity depth sampling")),
    ("perturb", dict(type=float, default=1.0,
                     help="factor to perturb depth sampling points")),
    ("noise_std", dict(type=float, default=1.0,
                       help="std dev of noise added to regularize sigma")),
    # schedule / optimizer ----------------------------------------------------
    ("batch_size", dict(type=int, default=1024, help="items per card per step")),
    ("chunk", dict(type=int, default=32 * 1024,
                   help="ray tile size for image-sized renders")),
    ("num_epochs", dict(type=int, default=80)),
    ("num_gpus", dict(type=int, default=4,
                      help="number of cards, one process each; the global batch is "
                           "batch_size * num_gpus (with --device cpu: gloo processes)")),
    ("ckpt_path", dict(type=str, default=None,
                       help="checkpoint to fully resume from")),
    ("prefixes_to_ignore", dict(nargs="+", type=str, default=["loss"])),
    ("optimizer", dict(type=str, default="adam",
                       choices=["sgd", "adam", "radam", "ranger"])),
    ("lr", dict(type=float, default=5e-4)),
    ("momentum", dict(type=float, default=0.9)),
    ("weight_decay", dict(type=float, default=0)),
    ("lr_scheduler", dict(type=str, default="steplr",
                          choices=["steplr", "cosine", "poly"])),
    ("warmup_multiplier", dict(type=float, default=1.0)),
    ("warmup_epochs", dict(type=int, default=0)),
    ("decay_step", dict(nargs="+", type=int, default=[20])),
    ("decay_gamma", dict(type=float, default=0.1)),
    ("poly_exp", dict(type=float, default=0.9)),
    ("exp_name", dict(type=str, default="exp")),
    # SinNeRF-specific --------------------------------------------------------
    ("with_ref", dict(flag=True)),
    ("patch_size", dict(type=int, default=-1)),
    ("patch_size_x", dict(type=int, default=-1)),
    ("patch_size_y", dict(type=int, default=-1)),
    ("pt_model", dict(type=str, default=None,
                      help="warm-start checkpoint (Step-2 consumes Step-1)")),
    ("model", dict(type=str, default="nerf", choices=["sinnerf"])),
    ("repeat", dict(type=int, default=1)),
    ("nW", dict(type=int, default=32)),
    ("nH", dict(type=int, default=32)),
    ("sW", dict(type=int, default=1, help="patch row stride")),
    ("sH", dict(type=int, default=1, help="patch col stride")),
    ("dloss", dict(type=str, default="hinge", help="GAN loss flavor")),
    ("load_depth", dict(flag=True)),
    ("nerf_only", dict(flag=True,
                       help="load only the coarse/fine NeRF from pt_model")),
    ("depth_type", dict(type=str, default="nerf")),
    ("dis_weight", dict(type=float, default=0.001)),
    ("proj_weight", dict(type=float, default=1)),
    ("angle", dict(type=int, default=20, help="rot3d pseudo-view angle")),
    ("scan", dict(type=int, default=4, help="DTU scan id")),
    ("depth_weight", dict(type=float, default=0.05)),
    ("vit_weight", dict(type=float, default=0)),
    ("depth_smooth_weight", dict(type=float, default=0)),
    ("depth_anneal", dict(flag=True)),
    ("loss_type", dict(type=str, default="mse",
                       choices=["mse", "l2_ssim", "l2_vgg"])),
    ("patch_loss", dict(type=str, default="mse",
                        choices=["mse", "l2_ssim", "l2_vgg"])),
    # the JAX package's extras (not in the reference) -------------------------
    ("compute_dtype", dict(type=str, default="bfloat16",
                           choices=["float32", "bfloat16"],
                           help="matmul compute dtype for the NeRF MLP")),
    ("mlp_impl", dict(type=str, default="pallas", choices=["xla", "pallas"],
                      help="pallas: the hand-written CUDA kernels; xla: plain PyTorch")),
    ("vit_weights", dict(type=str, default=None,
                         help="local DINO ViT-S/16 torch weights "
                              "(required for --vit_weight > 0 parity)")),
    ("vgg_weights", dict(type=str, default=None,
                         help="local torchvision VGG16 weights "
                              "(for --loss_type l2_vgg)")),
    ("allow_random_pretrained", dict(flag=True,
                                     help="permit random-init ViT/VGG when "
                                          "no weights path is given (tests "
                                          "only; the losses become noise)")),
    ("check_val_every_n_epoch", dict(type=int, default=20,
                                     help="validation cadence in epochs")),
    ("ckpt_dir", dict(type=str, default="ckpts")),
    ("log_dir", dict(type=str, default="logs")),
    ("seed", dict(type=int, default=0)),
    ("num_rays", dict(type=int, default=4096,
                      help="random rays per item (reference hardcodes 4096)")),
    ("ref_idx", dict(type=int, default=None,
                     help="reference frame index override (blender scenes "
                          "outside the built-in table need this)")),
    ("prefetch_batches", dict(type=int, default=8,
                              help="sample K steps' batches in one batched "
                                   "call of the sampler (within an epoch); "
                                   "the batches are those of K per-step "
                                   "calls, bit for bit; 1 samples per step")),
    ("profile", dict(flag=True,
                     help="write a torch.profiler trace of the fit into "
                          "log_dir (reference enables a profiler on "
                          "single-GPU runs, train.py:59)")),
    # the port's own --------------------------------------------------------
    ("device", dict(type=str, default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default) or, when asked, the CPU")),
]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    for name, spec in _FLAG_SPEC:
        spec = dict(spec)
        if spec.pop("flag", False):
            parser.add_argument(f"--{name}", default=False, action="store_true", help=spec.get("help"))
        else:
            parser.add_argument(f"--{name}", **spec)
    return parser


def get_opts(args=None):
    return build_parser().parse_args(args)

