"""The end-to-end times of one checkout on the card, so that two checkouts
can be compared in one call: ``train_step`` at ``chip_smoke.py``'s Step-1
shape (16,384 rays, 64 + 128 samples, Adam), stochastic and deterministic
(``perturb=0``, ``noise_std=0``), and the eval render of one 504x378 image
at 64 + 128 samples, each in bfloat16 and float32; then the train CLI's ms
per step on ``chip_smoke.py``'s LLFF run (bf16, 4 epochs of 5 steps) at
``--prefetch_batches`` 8 and 1 (a checkout without prefetching samples
step by step at both), and on lego Step 1 (one epoch of 125 steps) at the
checkout's default.

    python sinnerf_tpu_torch/scripts/step_times.py [--root CHECKOUT]

imports ``sinnerf_tpu_torch`` and ``chip_smoke`` from CHECKOUT (by default
the checkout this file lies in), so the same measurement runs on another
commit's code: unpack that commit with ``git archive`` and run parent,
change, change, parent in one call.  Each time is CUDA events around
``chip_smoke.TRAIN_STEPS`` steps after one warm-up step, or around two
renders after one; the weights and batches are ``chip_smoke.py``'s, from
its seeds.  Prints the card (``nvidia-smi`` name and power limit) and one
JSON line.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from sinnerf_tpu_torch import eval as port_eval
    from sinnerf_tpu_torch.data.llff import LLFFEval
    from sinnerf_tpu_torch.data.synthetic import make_blender_scene_rich
    from sinnerf_tpu_torch.render.renderer import RenderSettings, render_chunked
    from sinnerf_tpu_torch.train.step import train_step

    if not torch.cuda.is_available():
        print("step_times: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    print(cs.card_line())
    rng = np.random.default_rng(0)
    batch = cs.make_train_batch(rng, device)
    draws = cs.make_draws(rng, 4 * cs.TRAIN_RAYS, device)
    out = {"root": root, "steps": cs.TRAIN_STEPS}
    for cd in ("bfloat16", "float32"):
        for kind, config, extra in (("stochastic", cs.train_config(cd), (draws,)), ("deterministic", cs.det_config(cd), ())):
            state = cs.new_train_state(device)
            state, _ = train_step(state, batch, config, 0.0, *extra)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(cs.TRAIN_STEPS):
                state, _ = train_step(state, batch, config, 0.0, *extra)
            end.record()
            end.synchronize()
            out[f"{kind}_step_ms[{cd}]"] = start.elapsed_time(end) / cs.TRAIN_STEPS
            del state
            torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        scene, ckpt = cs.make_scene(workdir)
        models = port_eval.load_models(ckpt, device)
        rays = torch.from_numpy(LLFFEval(scene, split="val", img_wh=cs.IMG_WH).val_item(0)["rays"]).to(device)
        for cd in ("bfloat16", "float32"):
            settings = RenderSettings(n_samples=cs.N_SAMPLES, n_importance=cs.N_IMPORTANCE, compute_dtype=cd)
            out[f"image_ms[{cd}]"] = cs.timed(lambda: render_chunked(models, rays, settings, cs.eval_tile()), 2)[1]
        # the train CLI's ms per step (host clock over its epochs): phase 11's
        # stochastic bf16 LLFF run for 4 epochs of 5 steps, sampled 8 and 1
        # steps at a time, and phase 20's lego Step 1
        lego = make_blender_scene_rich(os.path.join(workdir, "lego"), cs.LEGO_WH)
        llff = cs.cli_flags(scene, workdir, "bfloat16", "llff") + ["--num_epochs", "4"]
        for name, flags in (("llff_k8", llff + ["--prefetch_batches", "8"]),
                            ("llff_k1", llff + ["--prefetch_batches", "1"]),
                            ("lego_step1", cs.slice_flags("blender_ray_patch_1image_rot3d", lego, workdir, "lego"))):
            trainer = cs.run_cli(flags)[0]
            out[f"cli_ms_per_step[{name}]"] = 1e3 * sum(e[2] for e in trainer.epoch_log) / sum(
                e[1] for e in trainer.epoch_log)
            del trainer
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
