"""Full-recipe soaks of the port on the rich synthetic scenes: the
counterpart of the JAX package's ``scripts/soak.sh``.

    python -m sinnerf_tpu_torch.scripts.soak {lego,llff,dtu,llff_vit0} [epochs1] [epochs2] \\
        [--work_dir DIR] [--log_dir DIR] [--legs step1,step2,eval] [-- <flags appended to every leg>]

For a family it writes its multi-view-consistent scene (the port's own
writers, ``data/synthetic.py``) at the legs' ``--img_wh``, then runs Step 1
(depth, projection and the random-weight ViT under
``--allow_random_pretrained``), Step 2 (the PatchGAN finetune warm-started
from Step 1's ``last.ckpt`` by ``--pt_model ... --nerf_only``), and the eval
CLI on Step 2's ``last.ckpt``.  ``llff_vit0`` is the ViT-free control: Step 1
only.  The flags are ``RECIPES``', one for one those of ``soak.sh``; only the
directories differ, and the checkpoint, a ``.ckpt`` file where JAX has an
orbax directory.  Epochs default to ``soak.sh``'s: lego 160 / 20 (125 steps
an epoch), the others 2000 / 2000.

Each leg runs in this process through the port's entry points
(``sinnerf_tpu_torch.train.__main__.main``, ``sinnerf_tpu_torch.eval.main``),
on the card unless ``-- --device cpu`` is given; a leg raises where it finds
no card.  Flags after ``--`` are appended to every leg (argparse keeps a
flag's last value); the eval leg drops those its CLI does not define.  A
leg whose ``<ck>/<exp>/last.ckpt`` exists resumes from it (``--ckpt_path``),
so a finished leg trains no further epoch and a soak can run in pieces; a
checkpoint is written at each validation, so cut epochs at a multiple of
``--check_val_every_n_epoch``.  A failed leg stops the soak.  ``--legs``
runs only the legs it names: Step 1 alone can then run to its full count
over several calls before Step 2 warm-starts from it.

After each run of a leg one JSON line is appended to
``<log_dir>/<exp>/soak.jsonl`` (``soak_status`` reads it): a train leg's
``loop.summary`` (``val_log``, ``epoch_log``, ``lr_log``, ``steps_per_epoch``,
``step``, ``best_psnr``), its ms per step (host clock per epoch), wall seconds, the
kernels' launches per kernel and dtype, and the card's name and power
limit; the eval leg's mean PSNR and ms per image.  Default directories lie
under ``soak_runs/`` of the checkout: ``ck/``, ``log/``, ``scenes/`` and the
eval CLI's ``results/``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_WORK_DIR = os.path.join(REPO, "soak_runs")
LEGS = ("step1", "step2", "eval")
DEFAULT_EPOCHS = {"lego": (160, 20), "llff": (2000, 2000), "dtu": (2000, 2000), "llff_vit0": (2000, 2000)}

# The families' flags as soak.sh:36-111 has them (COMMON, S1, S2, EVAL), with
# {root}, {ck}, {log}, {e1} and {e2} for its $ROOT, $CK, $LOG, $E1 and $E2;
# the checkpoints are the port's last.ckpt files.
_LLFF_COMMON = [
    "--dataset_name", "llff_ray_patch_1image_proj", "--root_dir", "{root}",
    "--N_importance", "64", "--img_wh", "504", "378", "--batch_size", "1", "--optimizer", "adam",
    "--lr_scheduler", "steplr", "--decay_step", "500", "1000", "--decay_gamma", "0.5",
    "--with_ref", "--patch_size_x", "63", "--patch_size_y", "84", "--proj_weight", "1",
    "--depth_smooth_weight", "0", "--num_gpus", "1", "--load_depth", "--depth_type", "nerf",
    "--model", "sinnerf", "--depth_weight", "8", "--ckpt_dir", "{ck}", "--log_dir", "{log}",
    "--check_val_every_n_epoch", "50",
]
RECIPES = {
    "llff": dict(
        scene="llff", exp1="llff_room_s4", exp2="llff_room_s4_2ft",
        common=_LLFF_COMMON,
        s1=["--num_epochs", "{e1}", "--lr", "2e-4", "--sW", "4", "--sH", "4", "--dis_weight", "0",
            "--vit_weight", "10", "--allow_random_pretrained", "--exp_name", "llff_room_s4"],
        s2=["--num_epochs", "{e2}", "--lr", "5e-5", "--sW", "2", "--sH", "2", "--dis_weight", "0.01",
            "--vit_weight", "0", "--exp_name", "llff_room_s4_2ft",
            "--pt_model", "{ck}/llff_room_s4/last.ckpt", "--nerf_only"],
        eval=["--dataset_name", "llff_ray_patch_1image_proj", "--root_dir", "{root}",
              "--N_importance", "64", "--img_wh", "504", "378", "--split", "test_train",
              "--ckpt_path", "{ck}/llff_room_s4_2ft/last.ckpt", "--timestamp", "soak"],
    ),
    "llff_vit0": dict(
        scene="llff", exp1="llff_room_s4_vit0", exp2=None,
        common=_LLFF_COMMON,
        s1=["--num_epochs", "{e1}", "--lr", "2e-4", "--sW", "4", "--sH", "4", "--dis_weight", "0",
            "--vit_weight", "0", "--exp_name", "llff_room_s4_vit0"],
        s2=None, eval=None,
    ),
    "lego": dict(
        scene="lego", exp1="lego_s6", exp2="lego_s6_4ft",
        common=[
            "--dataset_name", "blender_ray_patch_1image_rot3d", "--root_dir", "{root}",
            "--N_importance", "64", "--img_wh", "400", "400", "--batch_size", "1", "--optimizer", "adam",
            "--lr_scheduler", "steplr", "--decay_step", "500", "1000", "--decay_gamma", "0.5",
            "--with_ref", "--patch_size", "64", "--proj_weight", "1",
            "--depth_smooth_weight", "0", "--num_gpus", "1", "--load_depth", "--depth_type", "nerf",
            "--model", "sinnerf", "--depth_weight", "8", "--ckpt_dir", "{ck}", "--log_dir", "{log}",
            "--check_val_every_n_epoch", "10",
        ],
        s1=["--num_epochs", "{e1}", "--lr", "2e-4", "--sW", "6", "--sH", "6", "--dis_weight", "0",
            "--vit_weight", "10", "--allow_random_pretrained", "--exp_name", "lego_s6"],
        s2=["--num_epochs", "{e2}", "--lr", "5e-5", "--sW", "4", "--sH", "4", "--dis_weight", "0.01",
            "--vit_weight", "0", "--exp_name", "lego_s6_4ft",
            "--pt_model", "{ck}/lego_s6/last.ckpt", "--nerf_only"],
        eval=["--dataset_name", "blender_ray_patch_1image_rot3d", "--root_dir", "{root}",
              "--N_importance", "64", "--img_wh", "400", "400", "--split", "val",
              "--ckpt_path", "{ck}/lego_s6_4ft/last.ckpt", "--timestamp", "soak"],
    ),
    "dtu": dict(
        scene="dtu", exp1="dtu_scan4_s8", exp2="dtu_scan4_s8_4ft",
        common=[
            "--dataset_name", "dtu_proj", "--root_dir", "{root}", "--scan", "4",
            "--N_importance", "64", "--img_wh", "640", "512", "--batch_size", "1", "--optimizer", "adam",
            "--lr_scheduler", "steplr", "--decay_step", "500", "1000", "--decay_gamma", "0.5",
            "--with_ref", "--patch_size_y", "70", "--patch_size_x", "56", "--proj_weight", "1",
            "--depth_smooth_weight", "0", "--num_gpus", "1", "--load_depth", "--depth_type", "nerf",
            "--model", "sinnerf", "--depth_weight", "8", "--ckpt_dir", "{ck}", "--log_dir", "{log}",
            "--check_val_every_n_epoch", "50",
        ],
        s1=["--num_epochs", "{e1}", "--lr", "2e-4", "--sW", "8", "--sH", "8", "--dis_weight", "0",
            "--vit_weight", "10", "--allow_random_pretrained", "--exp_name", "dtu_scan4_s8"],
        s2=["--num_epochs", "{e2}", "--lr", "5e-5", "--sW", "4", "--sH", "4", "--dis_weight", "0.01",
            "--vit_weight", "0", "--exp_name", "dtu_scan4_s8_4ft",
            "--pt_model", "{ck}/dtu_scan4_s8/last.ckpt", "--nerf_only"],
        eval=["--dataset_name", "dtu_proj", "--root_dir", "{root}", "--scan", "4",
              "--N_importance", "64", "--img_wh", "640", "512", "--split", "val",
              "--ckpt_path", "{ck}/dtu_scan4_s8_4ft/last.ckpt", "--timestamp", "soak"],
    ),
}


def fill(flags: Sequence[str], **paths) -> List[str]:
    """``flags`` with the placeholders of ``RECIPES`` filled in."""
    return [f.format(**paths) for f in flags]


def known_flags(flags: Sequence[str], names) -> List[str]:
    """The ``--name value...`` groups of ``flags`` whose name is one of
    ``names``."""
    groups: List[List[str]] = []
    for f in flags:
        if f.startswith("--") or not groups:
            groups.append([f])
        else:
            groups[-1].append(f)
    return [f for g in groups if g[0][2:] in names for f in g]


def card_line() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` gives them, or None
    where it does not run."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launches so far, in all and per dtype ("K1",
    "K1[bfloat16]"; K2 has one dtype)."""
    from sinnerf_tpu_torch.ops.fused_mlp import launch_mlp_bwd, launch_mlp_fwd
    from sinnerf_tpu_torch.ops.fused_render import fused_render_level
    from sinnerf_tpu_torch.ops.fused_render_train import launch_train_bwd, launch_train_fwd
    from sinnerf_tpu_torch.ops.fused_sample_pdf import fused_sample_pdf_merge

    counters = {"K1": fused_render_level, "K2": fused_sample_pdf_merge, "K3-fwd": launch_train_fwd,
                "K3-bwd": launch_train_bwd, "K4-fwd": launch_mlp_fwd, "K4-bwd": launch_mlp_bwd}
    out = {name: c.launches for name, c in counters.items()}
    out.update({f"{name}[{cd}]": n for name, c in counters.items() for cd, n in getattr(c, "launches_by_dtype",
                                                                                          {}).items()})
    return out


def measured(fn, device: str):
    """``fn()`` with the card synchronised after it: (its result, the
    kernels' launches during it, wall seconds)."""
    import torch

    before = launch_counts()
    t0 = time.perf_counter()
    result = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return result, {k: n - before[k] for k, n in launch_counts().items()}, wall


def _release(device: str) -> None:
    gc.collect()
    if device == "cuda":
        import torch

        torch.cuda.empty_cache()


def append_record(log_dir: str, exp: str, record: dict) -> None:
    path = os.path.join(log_dir, exp, "soak.jsonl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def write_scene(family: str, scenes_dir: str, img_wh) -> str:
    """The family's rich scene at ``img_wh`` under ``scenes_dir``, written
    when missing (into a temporary directory first, so that soaks started
    together never read half a scene)."""
    from sinnerf_tpu_torch.data import synthetic

    kind = RECIPES[family]["scene"]
    w, h = img_wh
    top = os.path.join(scenes_dir, f"rich_{kind}_{w}x{h}")
    # 'lego' in the path selects the Blender loader's mytest branch
    root = os.path.join(top, "lego") if kind == "lego" else top
    if os.path.isdir(top):
        return root
    os.makedirs(scenes_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".rich_{kind}_", dir=scenes_dir)
    tmp_root = os.path.join(tmp, "lego") if kind == "lego" else tmp
    if kind == "llff":
        synthetic.make_llff_scene_rich(tmp_root, img_wh=(w, h), n_images=10)
    elif kind == "lego":
        synthetic.make_blender_scene_rich(tmp_root, img_wh=(w, h))
    else:
        synthetic.make_dtu_scene_rich(tmp_root, img_wh=(w, h), n_src=8)
    try:
        os.rename(tmp, top)
    except OSError:  # another soak wrote it first
        shutil.rmtree(tmp, ignore_errors=True)
    return root


def run_train_leg(family: str, leg: str, exp: str, flags: List[str], ck: str, log_dir: str) -> dict:
    """One train leg through the train CLI's ``main``, resumed from
    ``<ck>/<exp>/last.ckpt`` when it exists; returns (and appends) its record."""
    from sinnerf_tpu_torch.opt import get_opts
    from sinnerf_tpu_torch.train.__main__ import main as train_main
    from sinnerf_tpu_torch.train.loop import SinNeRFTrainer, summary

    last = os.path.join(ck, exp, "last.ckpt")
    resumed = os.path.exists(last)
    argv = flags + (["--ckpt_path", last] if resumed else [])
    hparams = get_opts(argv)
    result, launches, wall = measured(lambda: train_main(hparams), hparams.device)
    summ = summary(result) if isinstance(result, SinNeRFTrainer) else result[0]
    steps = sum(e[1] for e in summ["epoch_log"])
    ms_per_step = 1e3 * sum(e[2] for e in summ["epoch_log"]) / steps if steps else None
    record = dict(leg=leg, family=family, exp=exp, time=time.time(), resumed_from=last if resumed else None,
                  argv=argv, **{k: summ[k] for k in ("val_log", "epoch_log", "lr_log", "steps_per_epoch",
                                                      "step", "best_psnr")},
                  steps=steps, ms_per_step=ms_per_step, wall_s=wall, launches_by_dtype=launches,
                  card=card_line() if hparams.device == "cuda" else None)
    del result
    _release(hparams.device)
    append_record(log_dir, exp, record)
    print(f"soak {family} {leg}: {steps} steps in this run (step {record['step']}), "
          f"{'n/a' if ms_per_step is None else f'{ms_per_step:.1f}'} ms per step, {wall:.1f} s, "
          f"val PSNR {summ['val_log']}")
    return record


def run_eval_leg(family: str, exp: str, flags: List[str], work_dir: str, log_dir: str) -> dict:
    """The eval CLI's ``main`` on Step 2's checkpoint, from ``work_dir`` (its
    ``results/`` go there); returns (and appends) its record."""
    from sinnerf_tpu_torch import eval as port_eval

    args = port_eval.get_opts(flags)
    with contextlib.chdir(work_dir):
        psnr, launches, wall = measured(lambda: port_eval.main(args), args.device)
    out_dir = os.path.join(work_dir, "results", args.dataset_name, args.scene_name, args.timestamp)
    images = len([p for p in glob.glob(os.path.join(out_dir, "*.png")) if not p.endswith("_depth.png")])
    record = dict(leg="eval", family=family, exp=exp, time=time.time(), argv=flags, mean_psnr=psnr,
                  images=images, ms_per_image=1e3 * wall / images if images else None, wall_s=wall,
                  launches_by_dtype=launches, card=card_line() if args.device == "cuda" else None)
    _release(args.device)
    append_record(log_dir, exp, record)
    print(f"soak {family} eval: mean PSNR {psnr} over {images} images, {wall:.1f} s")
    return record


def split_argv(argv: Sequence[str]):
    """(the soak's own arguments, the flags after ``--``)."""
    argv = list(argv)
    if "--" in argv:
        i = argv.index("--")
        return argv[:i], argv[i + 1:]
    return argv, []


def get_args(argv: Sequence[str]):
    p = argparse.ArgumentParser(description="Full-recipe soak of one family (see the module's docstring).")
    p.add_argument("family", choices=sorted(RECIPES))
    p.add_argument("epochs1", nargs="?", type=int, default=None, help="Step 1's epochs (soak.sh's default)")
    p.add_argument("epochs2", nargs="?", type=int, default=None, help="Step 2's epochs (soak.sh's default)")
    p.add_argument("--work_dir", default=DEFAULT_WORK_DIR,
                   help="holds ck/, scenes/, the eval CLI's results/ and, by default, log/")
    p.add_argument("--log_dir", default=None, help="the legs' --log_dir and the soak.jsonl records")
    p.add_argument("--legs", default=",".join(LEGS),
                   help="comma-separated legs to run, in the soak's order (default: all of them)")
    args = p.parse_args(argv)
    args.legs = tuple(args.legs.split(","))
    if not set(args.legs) <= set(LEGS):
        p.error(f"--legs: {args.legs} are not among {LEGS}")
    return args


def legs(family: str, e1: int, e2: int, root: str, ck: str, log_dir: str, extra: Sequence[str],
         only: Sequence[str] = LEGS):
    """The family's legs among ``only`` as (leg, exp, argv): Step 1, then
    (but for ``llff_vit0``) Step 2 and the eval CLI, each with ``extra``
    appended (the eval leg keeps those flags its CLI defines)."""
    from sinnerf_tpu_torch.eval import _EVAL_FLAGS

    r = RECIPES[family]
    paths = dict(root=root, ck=ck, log=log_dir, e1=e1, e2=e2)
    out = [("step1", r["exp1"], fill(r["common"] + r["s1"], **paths) + list(extra))]
    if r["s2"] is not None:
        out.append(("step2", r["exp2"], fill(r["common"] + r["s2"], **paths) + list(extra)))
        out.append(("eval", r["exp2"], fill(r["eval"], **paths) + known_flags(extra, {n for n, _ in _EVAL_FLAGS})))
    return [leg for leg in out if leg[0] in only]


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Run the family's soak; returns the legs' records."""
    from sinnerf_tpu_torch.opt import get_opts
    from sinnerf_tpu_torch.utils.device import resolve_device

    own, extra = split_argv(sys.argv[1:] if argv is None else argv)
    args = get_args(own)
    e1 = args.epochs1 if args.epochs1 is not None else DEFAULT_EPOCHS[args.family][0]
    e2 = args.epochs2 if args.epochs2 is not None else DEFAULT_EPOCHS[args.family][1]
    work_dir = os.path.abspath(args.work_dir)
    ck = os.path.join(work_dir, "ck")
    log_dir = os.path.abspath(args.log_dir or os.path.join(work_dir, "log"))
    # the scene at the legs' --img_wh, on the legs' device (a missing card raises here)
    probe = get_opts(fill(RECIPES[args.family]["common"] + RECIPES[args.family]["s1"], root="", ck=ck,
                          log=log_dir, e1=e1, e2=e2) + list(extra))
    device = resolve_device(probe.device).type
    t0 = time.perf_counter()
    root = write_scene(args.family, os.path.join(work_dir, "scenes"), probe.img_wh)
    print(f"soak {args.family}: scene {root} ({time.perf_counter() - t0:.1f} s), device {device}, epochs {e1} / "
          f"{e2}, log {log_dir}")
    records = []
    for leg, exp, flags in legs(args.family, e1, e2, root, ck, log_dir, extra, args.legs):
        print(f"=== {args.family} {leg} ({exp}) ===", flush=True)
        if leg == "eval":
            records.append(run_eval_leg(args.family, exp, flags, work_dir, log_dir))
            continue
        if leg == "step2":
            warm = os.path.join(ck, RECIPES[args.family]["exp1"], "last.ckpt")
            if not os.path.exists(warm):
                raise RuntimeError(f"Step 1 left no {warm}: a checkpoint is written at each validation, so its "
                                   "epochs must be a multiple of --check_val_every_n_epoch")
        records.append(run_train_leg(args.family, leg, exp, flags, ck, log_dir))
    return records


if __name__ == "__main__":
    main()
