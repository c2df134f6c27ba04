#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sinnerf_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, any failure exits non-zero without the final result line:
1. print the card (``nvidia-smi`` name and power limit) and build the CUDA
   kernels from ``sinnerf_tpu_torch/csrc`` (build seconds printed);
2. hold K1 (``fused_render_level``) against its plain version, float32 and
   bfloat16, at 4096 rays x S = 64 and 192 and 1000 rays x S = 12 with the
   white background on and off;
3. hold K2 (``fused_sample_pdf_merge``) against its plain version;
4. on a synthetic 504x378 LLFF scene with a reference-format ``.ckpt``,
   hold each kernel against its plain version on the inputs and at the
   shapes the eval path gives it (one val image in tiles of 131,072 rays:
   K1 at 131072 and 59440 rays x S = 64 and 192, K2 at 131072 and 59440
   rays x 64 -> 192), timing each launch and its plain version; then hold
   the kernel render of the whole image against the plain render path and
   time it;
5. the main path: ``sinnerf_tpu_torch.eval`` on the val and test splits at
   64 + 128 samples in bfloat16 and float32, with every launch count set to
   0 just before and read just after; check PSNR and PNGs;
6. print one ``kernels`` JSON line, then, last,
   ``{"ok": true, "device": {...}}``.

Errors are max and mean absolute differences of rgb, weights and depth (as a
share of the far bound).  Kernel and plain version cast at the same points;
in bfloat16 an f32 sum taken in another order can round an activation to the
neighbouring bf16 value, which the max sees and the mean hardly does.  A
cast point missed shifts every point, which the mean sees (the planted
faults of ``tests/test_torch_kernels_plain.py`` show it).

The script imports nothing of JAX.  It exits non-zero without a card, and in
a directory that does not hold the port.
"""

from __future__ import annotations

import glob
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks (NVIDIA data sheet, 700 W)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
MAC_PER_POINT = 593_408  # the 13 products of the reference NeRF, per point
IMG_WH = (504, 378)
N_SAMPLES, N_IMPORTANCE = 64, 128
PLAIN_CHUNK = 8192  # rays per call of a plain version at the eval shapes
# kernel vs plain version: (max, mean) absolute error allowed.  Measured on
# an H100 (PERF.md): max 1.3e-6 and mean 2.4e-7 in float32, max 9.2e-5 and
# mean 2.9e-7 in bfloat16; the planted bf16 faults reach means of 4.1e-6
K1_TOL = {"float32": (2e-5, 1e-6), "bfloat16": (1e-3, 1e-6)}
K2_TOL = (1e-5, 1e-6)  # rtol, atol; measured bit-equal
# kernel render path vs plain render path on a whole image: (max, mean);
# measured max 2.0e-6, mean 2.5e-7 (float32) and 7.3e-5, 3.6e-7 (bfloat16)
IMAGE_TOL = {"float32": (2e-5, 1e-6), "bfloat16": (1e-3, 2e-6)}


class Failed(Exception):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def timed(fn, reps: int):
    """One warm-up call, then the mean of ``reps`` calls in ms by CUDA
    events.  Returns (the warm-up call's result, ms)."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / reps


def make_params(seed: int):
    """Reference-width NeRF params from a numpy seed; the sigma head is
    shifted so that the random field is partly opaque (a field that is all
    empty composites to zeros and checks nothing)."""
    from sinnerf_tpu_torch.models.nerf import random_params

    p = random_params(np.random.default_rng(seed))
    p["sigma"]["b"] = p["sigma"]["b"] + np.float32(0.3)
    return p


def make_model(seed: int, device):
    from sinnerf_tpu_torch.models.nerf import nerf_from_state, state_dict_from_jax

    return nerf_from_state(state_dict_from_jax(make_params(seed))).to(device).eval()


def make_rays(rng, n: int, s: int, device):
    """Rays (N, 6) and ascending jittered depths (N, S) in [2, 6]."""
    import torch

    from sinnerf_tpu_torch.core.sampling import stratified_z_vals

    o = rng.normal(scale=0.3, size=(n, 3))
    d = rng.normal(scale=0.3, size=(n, 3)) + [0.0, 0.0, -1.0]
    rays = torch.tensor(np.concatenate([o, d], 1), dtype=torch.float32, device=device)
    near = torch.full((n, 1), 2.0, device=device)
    far = torch.full((n, 1), 6.0, device=device)
    u = torch.tensor(rng.uniform(size=(n, s)), dtype=torch.float32, device=device)
    z = stratified_z_vals(near, far, s, perturb=1.0, u=u)
    return rays, z


def k1_error(got, ref, far: float = 6.0):
    """(max, mean) absolute error of a render (rgb, depth, weights) against
    its reference, depth as a share of ``far``."""
    for t in got:
        if not bool(t.isfinite().all()):
            raise Failed("fused_render_level returned non-finite values")
    diffs = [(g.float() - r.float()).abs() / scale for g, r, scale in zip(got, ref, (1.0, far, 1.0))]
    return max(d.max().item() for d in diffs), max(d.mean().item() for d in diffs)


def hold(what: str, err, tol) -> None:
    print(f"{what}: max err {err[0]:.3e} (tol {tol[0]:.0e}), mean {err[1]:.3e} (tol {tol[1]:.0e})")
    if not (err[0] <= tol[0] and err[1] <= tol[1]):
        raise Failed(f"{what} disagrees with its plain version")


def k2_error(got, ref, what: str) -> float:
    if got.shape != ref.shape or not bool(got.isfinite().all()):
        raise Failed(f"{what}: shape {tuple(got.shape)} or non-finite values")
    if not bool((got[:, 1:] >= got[:, :-1]).all()):
        raise Failed(f"{what}: rows are not ascending")
    rtol, atol = K2_TOL
    err = (got - ref).abs()
    print(f"{what}: max err {err.max().item():.3e} (tol {atol:.0e} + {rtol:.0e}|z|)")
    if (err - (atol + rtol * ref.abs())).max().item() > 0:
        raise Failed(f"{what} disagrees with its plain version")
    return err.max().item()


def in_chunks(fn, n: int, *args):
    """A plain version over rays [i, i + PLAIN_CHUNK), concatenated; rays
    are independent, and the chunks keep its (P, 256) activations small."""
    import torch

    outs = [fn(*(a[i : i + PLAIN_CHUNK] for a in args)) for i in range(0, n, PLAIN_CHUNK)]
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs)
    return tuple(torch.cat(parts) for parts in zip(*outs))


def k1_bound(n: int, s: int, cd: str):
    from sinnerf_tpu_torch.ops.fused_mlp import BIAS_SIZE, WEIGHT_SIZE

    flops = 2.0 * MAC_PER_POINT * n * s
    wbytes = WEIGHT_SIZE * (2 if cd == "bfloat16" else 4) + BIAS_SIZE * 4
    nbytes = n * 6 * 4 + n * s * 4 + wbytes + n * 3 * 4 + n * 4 + n * s * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[cd] * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def k2_bound(n: int, s: int, k: int) -> float:
    return (2 * n * s * 4 + n * (s + k) * 4) / PEAK_BYTES * 1e3


def phase_k1_checks(device, rng):
    import torch

    from sinnerf_tpu_torch.ops.fused_render import fused_render_level, render_level_plain

    model = make_model(1, device)
    worst = {}
    for n, s, white_back in ((4096, 64, False), (4096, 192, False), (1000, 12, False), (1000, 12, True)):
        rays, z = make_rays(rng, n, s, device)
        for cd in ("float32", "bfloat16"):
            got = fused_render_level(model, rays, z, True, white_back, cd)
            torch.cuda.synchronize()
            ref = render_level_plain(model, rays, z, True, white_back, cd)
            if got[2].shape != (n, s) or got[0].shape != (n, 3):
                raise Failed(f"fused_render_level shapes {[tuple(g.shape) for g in got]}")
            err = k1_error(got, ref)
            hold(f"K1 {cd:8s} n={n:5d} S={s:3d} white_back={int(white_back)}", err, K1_TOL[cd])
            worst[cd] = tuple(max(a, b) for a, b in zip(worst.get(cd, (0.0, 0.0)), err))
    return worst


def phase_k2_checks(device, rng):
    import torch

    from sinnerf_tpu_torch.ops.fused_sample_pdf import fused_sample_pdf_merge, sample_pdf_merge_plain

    worst = 0.0
    for n, s, k, det in ((4096, 64, 64, True), (4096, 64, 64, False), (4096, 64, 128, True),
                         (4096, 64, 128, False), (4096, 64, 1, True), (4096, 64, 1, False),
                         (1000, 64, 128, True), (1000, 64, 128, False)):
        _, z = make_rays(rng, n, s, device)
        w = torch.tensor(rng.uniform(size=(n, s)) ** 4, dtype=torch.float32, device=device)
        u = None if det else torch.tensor(rng.uniform(size=(n, k)), dtype=torch.float32, device=device)
        got = fused_sample_pdf_merge(z, w, k, u, det)
        torch.cuda.synchronize()
        ref = sample_pdf_merge_plain(z, w, k, u, det)
        worst = max(worst, k2_error(got, ref, f"K2 n={n:5d} S={s} K={k:3d} det={int(det)}"))
    return worst


def make_scene(workdir: str):
    """The 504x378 LLFF scene and a reference-format .ckpt of random weights."""
    from sinnerf_tpu_torch.data.synthetic import make_llff_scene
    from sinnerf_tpu_torch.models.nerf import state_dict_from_jax
    from sinnerf_tpu_torch.train.checkpoints import save_torch_nerf_checkpoint

    root = make_llff_scene(os.path.join(workdir, "llff"), IMG_WH)
    ckpt = save_torch_nerf_checkpoint(
        os.path.join(workdir, "ckpts", "smoke.ckpt"),
        {"coarse": state_dict_from_jax(make_params(10)), "fine": state_dict_from_jax(make_params(11))},
    )
    return root, ckpt


def eval_tile() -> int:
    from sinnerf_tpu_torch.render.renderer import pick_val_tile

    w, h = IMG_WH
    return pick_val_tile(w * h, 32 * 1024 * 4)  # eval.py's default --chunk


def phase_path(device, root: str, ckpt: str):
    """Each kernel against its plain version at the eval path's shapes, on
    the rays of one val image and the inputs the path gives each launch
    (as ``render_rays`` chains them); then the kernel render path against
    the plain render path on the whole image."""
    import torch

    from sinnerf_tpu_torch import eval as port_eval
    from sinnerf_tpu_torch.core.sampling import stratified_z_vals
    from sinnerf_tpu_torch.data.llff import LLFFEval
    from sinnerf_tpu_torch.ops.fused_render import fused_render_level, render_level_plain
    from sinnerf_tpu_torch.ops.fused_sample_pdf import fused_sample_pdf_merge, sample_pdf_merge_plain
    from sinnerf_tpu_torch.render.renderer import RenderSettings, render_chunked

    models = port_eval.load_models(ckpt, device)
    rays = torch.from_numpy(LLFFEval(root, split="val", img_wh=IMG_WH).val_item(0)["rays"]).to(device)
    n_all, tile = rays.shape[0], eval_tile()
    far = rays[:, 7].max().item()
    out = {"k1": {}, "k2": [], "image": {}}
    for cd in ("bfloat16", "float32"):
        launches, worst = [], (0.0, 0.0)

        def k1(level, r, z):
            nonlocal worst
            n, s = z.shape
            got, ms = timed(lambda: fused_render_level(models[level], r, z, True, False, cd), 2)
            ref, plain_ms = timed(lambda: in_chunks(
                lambda rr, zz: render_level_plain(models[level], rr, zz, True, False, cd), n, r, z), 1)
            err = k1_error(got, ref, far)
            bound_ms, bound_by = k1_bound(n, s, cd)
            hold(f"path K1 {cd:8s} {level:6s} n={n:6d} S={s:3d} ({ms:.3f} ms, plain {plain_ms:.3f} ms, "
                 f"bound {bound_ms:.3f} ms)", err, K1_TOL[cd])
            worst = tuple(max(a, b) for a, b in zip(worst, err))
            launches.append(dict(shape=f"{n}x{s}", ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by))
            return got

        for i in range(0, n_all, tile):
            r = rays[i : i + tile]
            n = r.shape[0]
            z = stratified_z_vals(r[:, 6:7], r[:, 7:8], N_SAMPLES, False, 0.0)
            _, _, w_c = k1("coarse", r, z)
            z_all, ms = timed(lambda: fused_sample_pdf_merge(z, w_c, N_IMPORTANCE, None, True), 10)
            ref, plain_ms = timed(lambda: in_chunks(
                lambda zz, ww: sample_pdf_merge_plain(zz, ww, N_IMPORTANCE, None, True), n, z, w_c), 3)
            out["k2"].append(dict(shape=f"{n}x{N_SAMPLES}+{N_IMPORTANCE}", ms=ms, plain_ms=plain_ms,
                                  bound_ms=k2_bound(n, N_SAMPLES, N_IMPORTANCE),
                                  err=k2_error(z_all, ref, f"path K2 {cd:8s} n={n:6d} ({ms:.3f} ms, "
                                                           f"plain {plain_ms:.3f} ms)")))
            k1("fine", r, z_all)
        out["k1"][cd] = dict(launches=launches, err=worst)

        settings = RenderSettings(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, compute_dtype=cd)
        res, ms = timed(lambda: render_chunked(models, rays, settings, tile), 2)
        ref = render_chunked(models, rays, RenderSettings(
            n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, compute_dtype=cd, mlp_impl="xla"), PLAIN_CHUNK)
        if res["rgb_fine"].shape != (n_all, 3):
            raise Failed(f"eval render has shape {tuple(res['rgb_fine'].shape)}")
        err = k1_error(*[(x["rgb_fine"], x["depth_fine"], x["opacity_fine"]) for x in (res, ref)], far)
        hold(f"image {cd:8s} kernel path vs plain path, {ms:.1f} ms per image", err, IMAGE_TOL[cd])
        k1_ms = sum(x["ms"] for x in launches)
        k2_ms = sum(x["ms"] for x in out["k2"][-math.ceil(n_all / tile):])
        print(f"image {cd:8s}: {ms:.1f} ms = K1 {k1_ms:.1f} + K2 {k2_ms:.3f} + rest {ms - k1_ms - k2_ms:.1f} ms")
        out["image"][cd] = dict(ms=ms, err=err)
        torch.cuda.empty_cache()
    return out


def phase_eval(device, workdir: str, root: str, ckpt: str, splits):
    """The main path: the port's eval CLI on the 504x378 LLFF scene."""
    import torch

    from sinnerf_tpu_torch import eval as port_eval
    from sinnerf_tpu_torch.ops.fused_render import fused_render_level
    from sinnerf_tpu_torch.ops.fused_sample_pdf import fused_sample_pdf_merge

    w, h = IMG_WH
    tiles = math.ceil(w * h / eval_tile())
    out = {"launches": {}, "psnr": {}}
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        for cd, cd_splits in splits:
            n_images = 0
            fused_render_level.launches = 0
            fused_sample_pdf_merge.launches = 0
            for split in cd_splits:
                args = port_eval.get_opts([
                    "--root_dir", root, "--dataset_name", "llff", "--split", split,
                    "--scene_name", f"smoke_{cd}_{split}", "--img_wh", str(w), str(h),
                    "--N_samples", str(N_SAMPLES), "--N_importance", str(N_IMPORTANCE),
                    "--ckpt_path", ckpt, "--compute_dtype", cd, "--device", "cuda",
                ])
                t0 = time.perf_counter()
                psnr = port_eval.main(args)
                torch.cuda.synchronize()
                n_split = len(glob.glob(os.path.join(workdir, "results", "llff", args.scene_name, "*", "*.png")))
                n_images += n_split
                print(f"eval {cd} {split}: {n_split} images in {time.perf_counter() - t0:.1f} s, PSNR {psnr}")
                if split == "val":
                    if psnr is None or not math.isfinite(psnr):
                        raise Failed(f"eval {cd} val PSNR is {psnr}")
                    out["psnr"][cd] = psnr
                if n_split == 0:
                    raise Failed(f"eval {cd} {split} wrote no PNG")
            k1, k2 = fused_render_level.launches, fused_sample_pdf_merge.launches
            out["launches"][cd] = (k1, k2, n_images)
            print(f"launches {cd}: K1 {k1}, K2 {k2} over {n_images} images of {tiles} tiles")
            if k1 != 2 * tiles * n_images or k2 != tiles * n_images:
                raise Failed(f"launch counts K1 {k1}, K2 {k2} != {2 * tiles * n_images}, {tiles * n_images}")
    finally:
        os.chdir(cwd)
    return out


def mean_of(rows, key: str) -> float:
    return sum(r[key] for r in rows) / len(rows)


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "sinnerf_tpu_torch")):
        print("chip_smoke: the sinnerf_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from sinnerf_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    try:
        print(f"build: {_build.build():.1f} s")
        for log in sorted(glob.glob(str(_build.BUILD_DIR / "*.log"))):
            with open(log) as f:
                usage = [ln.strip() for ln in f if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
            print(os.path.basename(log), *usage, sep="\n  ")
        rng = np.random.default_rng(0)
        k1_err = phase_k1_checks(device, rng)
        k2_err = phase_k2_checks(device, rng)
        splits = (("bfloat16", ("val", "test")), ("float32", ("val", "test")))
        with tempfile.TemporaryDirectory() as workdir:
            root, ckpt = make_scene(workdir)
            path = phase_path(device, root, ckpt)
            ev = phase_eval(device, workdir, root, ckpt, splits)
    except Failed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    kernels = []
    for cd in ("bfloat16", "float32"):
        p = path["k1"][cd]
        launches = p["launches"]
        kernels.append(dict(
            name=f"fused_render_level[{cd}]", route="cuda",
            source="sinnerf_tpu_torch/csrc/fused_render.cu",
            replaces="sinnerf_tpu/ops/fused_render_t.py:61",
            launches=ev["launches"][cd][0],
            max_abs_err=max(k1_err[cd][0], p["err"][0]), mean_abs_err=max(k1_err[cd][1], p["err"][1]),
            tolerance=K1_TOL[cd],
            ms=mean_of(launches, "ms"), plain_ms=mean_of(launches, "plain_ms"),
            bound_ms=mean_of(launches, "bound_ms"), bound_by=launches[0]["bound_by"], library_ms=None,
            per_launch={x["shape"]: [x["ms"], x["plain_ms"], x["bound_ms"]] for x in launches},
            image_ms=path["image"][cd]["ms"], image_err=path["image"][cd]["err"], images=ev["launches"][cd][2],
        ))
    k2 = path["k2"]
    kernels.append(dict(
        name="fused_sample_pdf_merge", route="cuda",
        source="sinnerf_tpu_torch/csrc/fused_sample_pdf.cu",
        replaces="sinnerf_tpu/ops/fused_sample_pdf_t.py:61",
        launches=sum(ev["launches"][cd][1] for cd in ev["launches"]),
        max_abs_err=max([k2_err] + [x["err"] for x in k2]), tolerance=f"{K2_TOL[1]} + {K2_TOL[0]}|z|",
        ms=mean_of(k2, "ms"), plain_ms=mean_of(k2, "plain_ms"), bound_ms=mean_of(k2, "bound_ms"),
        bound_by="bytes", library_ms=None,
        per_launch={x["shape"]: [x["ms"], x["plain_ms"], x["bound_ms"]] for x in k2[:2]},
    ))
    print(f"total {time.perf_counter() - t0:.1f} s; ms, plain_ms and bound_ms are means over the eval path's "
          f"launches of one image; no single PyTorch call computes either kernel's function")
    print(json.dumps({"kernels": kernels, "card": card, "psnr": ev["psnr"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
