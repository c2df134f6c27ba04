"""The eval leg: ``sinnerf_tpu_torch/eval.py::run``'s body per image, on
the benchmark's weights: ``val_item``, the rays to the card,
``render_chunked`` at ``pick_val_tile(w * h, chunk, 1)``, ``rgb_fine`` to
the host, then the uint8 image and the PSNR.  The PNG, depth and GIF writes
are left out.

Set-up writes the scene from the seed, builds the split's dataset as the
eval CLI does and renders one image, which runs every shape of the cell.
The window renders the split's images in turn until ``--seconds`` have
passed.  The checked images (``checked_images`` of the split, drawn from the
seed) keep their ``rgb_fine``; after the window the
reference renders the same views from the scene's raw camera file and the
same weights.
"""

from __future__ import annotations

import gc
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from benchmark import draws, judge, trace
from benchmark.reference.nerf import NeRF as RefNeRF
from benchmark.reference.render import Settings, plain_matmuls, render_image
from benchmark.reference.scene import llff_views
from benchmark.train_leg import _scene

VIEWS = {"llff_ray_patch_1image_proj": llff_views, "llff": llff_views}


class EvalLeg:
    """One run of an eval cell."""

    def __init__(self, cell, seed: int, device: str, work_dir: str, extra_flags=()):
        from sinnerf_tpu_torch.data import dataset_dict
        from sinnerf_tpu_torch.eval import get_opts
        from sinnerf_tpu_torch.models.nerf import NeRF
        from sinnerf_tpu_torch.render.renderer import RenderSettings, pick_val_tile

        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        cfg, tr = cell.config, cell.traffic
        self.scene = _scene(cfg, work_dir, seed)
        args = get_opts([*cfg["eval_flags"], *tr["flags"], "--root_dir", self.scene, "--ckpt_path", "none",
                         "--device", self.device.type, *extra_flags])
        self.args = args
        kwargs = dict(vars(args))
        kwargs["img_wh"] = tuple(args.img_wh)
        root = kwargs.pop("root_dir")
        split = kwargs.pop("split")
        self.dataset = dataset_dict[args.dataset_name](root, split=split, **kwargs)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.weights = draws.weights(gen, vit=False, disc_imsize=None)
        self.models = {}
        for level in ("coarse", "fine"):
            model = NeRF().to(self.device).eval()
            model.load_state_dict(self.weights[level])
            self.models[level] = model
        self.settings = RenderSettings(
            n_samples=args.N_samples, n_importance=args.N_importance, use_disp=args.use_disp, perturb=0.0,
            noise_std=0.0, white_back=self.dataset.white_back, compute_dtype=args.compute_dtype,
            mlp_impl=args.mlp_impl)
        w, h = args.img_wh
        self.tile = pick_val_tile(w * h, args.chunk, 1)
        n = self.dataset.val_len()
        pick = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
        self.check = sorted(int(i) for i in pick[: min(n, int(tr["checked_images"]))])
        self.kept: Dict[int, Dict[str, Any]] = {}
        self.next_image = 0
        self.psnrs: List[float] = []

    def _image(self, i: int, spans: trace.Spans) -> bool:
        """One image through the eval CLI's body; False if its pixels are
        not finite."""
        from sinnerf_tpu_torch.render.renderer import render_chunked

        w, h = self.args.img_wh
        with spans.span("val_item"):
            sample = self.dataset.val_item(i)
        with spans.span("to_device"):
            rays = torch.from_numpy(sample["rays"]).to(self.device)
        with spans.span("render"):
            results = render_chunked(self.models, rays, self.settings, tile=self.tile)
        with spans.span("to_host"):
            img_pred = results["rgb_fine"].cpu().numpy().reshape(h, w, 3)
        with spans.span("image"):
            (np.clip(img_pred, 0, 1) * 255).astype(np.uint8)
            if "rgbs" in sample:
                img_gt = np.asarray(sample["rgbs"]).reshape(h, w, 3)
                self.psnrs.append(float(-10.0 * np.log10(np.mean((img_pred - img_gt) ** 2))))
        if i in self.check and i not in self.kept:
            self.kept[i] = {"rgb_fine": torch.from_numpy(img_pred.reshape(-1, 3))}
        return bool(np.isfinite(img_pred).all())

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm_up(self) -> None:
        self._image(0, trace.Spans(False))
        self.kept.clear()
        self._sync()

    def window(self, seconds: float, spans: trace.Spans) -> Dict[str, Any]:
        """The split's images in turn until ``seconds`` have passed, and at
        least until every checked image has been rendered once."""
        n = self.dataset.val_len()
        images = failed = 0
        t0 = time.perf_counter()
        with spans.span("window"):
            while time.perf_counter() - t0 < seconds or len(self.kept) < len(self.check):
                ok = self._image(self.next_image, spans)
                self.next_image = (self.next_image + 1) % n
                images += 1
                failed += 0 if ok else 1
        return {"window_s": time.perf_counter() - t0, "images": images, "failed": failed}

    def end_to_end(self, w: Dict[str, Any]) -> Dict[str, float]:
        return {"eval_image_ms": 1e3 * w["window_s"] / w["images"]}

    def counters(self) -> Dict[str, Any]:
        w, h = self.args.img_wh
        return {"dtype": self.args.compute_dtype, "n_samples": self.args.N_samples,
                "n_importance": self.args.N_importance, "rays": w * h, "tile": self.tile}

    # ------------------------------------------------------------ the check
    def free(self) -> List[Dict[str, torch.Tensor]]:
        prog = [self.kept[i] for i in self.check]
        self.models = self.kept = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return prog

    def reference(self, precision: Optional[str] = None) -> List[Dict[str, torch.Tensor]]:
        """The reference's renders of the checked views; ``precision`` is
        the control's."""
        views = VIEWS[self.args.dataset_name](self.scene, tuple(self.args.img_wh))
        s = Settings(n_samples=self.args.N_samples, n_importance=self.args.N_importance, perturb=0.0,
                     noise_std=0.0, white_back=self.cell.config["white_back"], precision=precision)
        out = []
        with plain_matmuls():
            models = {}
            for level in ("coarse", "fine"):
                models[level] = RefNeRF().to(self.device)
                models[level].load_state_dict(self.weights[level])
            for i in self.check:
                r = render_image(models, torch.from_numpy(views[i]).to(self.device), s)
                out.append({k: v.cpu() for k, v in r.items()})
        return out

    def numbers(self, prog, ref) -> Dict[str, float]:
        return judge.image_numbers(prog, ref)
