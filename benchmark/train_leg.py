"""The train leg: ``SinNeRFTrainer`` as the train CLI builds it, driven
through ``_run_epoch`` (the sampler's groups, ``train_step``, the deferred
logs, a synchronise at the epoch's end) for whole epochs.

Set-up writes the scene from the seed, builds the trainer from the
configuration's and the traffic's flags, loads the benchmark's weights into
its models and runs ``warmup_steps`` steps as one short epoch.  The first
``checked_steps`` of them run with the benchmark's draws and are recorded:
their batches, losses, Adam's first moments after the first and the
parameters after the last.  The window then runs whole epochs until
``--seconds`` have passed.  After it, the program is freed and the reference
(``benchmark/reference``) replays the checked steps from the same weights,
batches and draws.

The benchmark's hook around ``train_step`` (the name ``_run_epoch`` calls)
records a CUDA event after each step returns, for the steps' lengths; in a
traced run it also marks the step, and a wrapper around the epoch's batch
generator times and marks each ``next()`` (the sampler).
"""

from __future__ import annotations

import gc
import math
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from benchmark import draws, judge, trace
from benchmark.reference.discriminator import Discriminator as RefDiscriminator
from benchmark.reference.nerf import NeRF as RefNeRF
from benchmark.reference.render import Settings, plain_matmuls
from benchmark.reference.step import Adam, StepConfig, losses as ref_losses
from benchmark.reference.vit import ViT as RefViT, frozen

BUNDLES = ("rays", "depth_ray", "rays_full", "rays_proj")
D_RATE = 0.2  # the recipes' discriminator learns at 0.2x --lr


def _scene(config: Dict[str, Any], root: str, seed: int) -> str:
    from sinnerf_tpu_torch.data import synthetic

    writer = getattr(synthetic, config["scene"]["writer"])
    return writer(os.path.join(root, config["scene"].get("dir", "scene")), tuple(config["scene"]["img_wh"]),
                  seed=seed)


def _step_rays(batch: Dict[str, torch.Tensor]) -> int:
    return sum(batch[k].shape[0] * batch[k].shape[1] for k in BUNDLES)


class StepHook:
    """Stands in for ``train_step`` in the trainer's module: checks the
    first steps it is asked to, records an event after every step, marks
    steps in a traced run, and counts each step's rays."""

    def __init__(self, loop_module, n_check: int, generator: torch.Generator, render: Dict[str, int]):
        self.loop = loop_module
        self.orig = loop_module.train_step
        self.n_check = n_check
        self.generator = generator
        self.render = render
        self.checked: List[Dict[str, Any]] = []
        self.fault = None  # a test's broken step: fault(orig, args, kwargs) -> (state, out)
        self.reset(trace.Spans(False), timing=False)

    def reset(self, spans: trace.Spans, timing: bool) -> None:
        self.spans = spans
        self.events: Optional[List[torch.cuda.Event]] = [] if timing else None
        self.losses: List[torch.Tensor] = []
        self.rays: List[int] = []

    def install(self) -> None:
        self.loop.train_step = self

    def remove(self) -> None:
        self.loop.train_step = self.orig

    def _check_draws(self, state, batch):
        from sinnerf_tpu_torch.models.diffaug import DiffAugDraws
        from sinnerf_tpu_torch.models.discriminator import DCallDraws
        from sinnerf_tpu_torch.train.step import RenderDraws, Step2Draws

        rd = draws.render_draws(_step_rays(batch), self.render["n_samples"], self.render["n_importance"],
                                self.generator)
        record = {"batch": {k: v.detach().clone() for k, v in batch.items()}, "render": rd}
        s2 = {}
        if state.vit is not None:
            record["refresh"] = draws.refresh_coins(batch["rays"].shape[0], self.generator)
            s2["refresh"] = record["refresh"]
        if state.discriminator is not None:
            calls = [draws.d_call_draws(batch["real_patch"], self.generator) for _ in range(3)]
            record["d_calls"] = calls
            prog = [DCallDraws(coin=c.coin, aug=DiffAugDraws(**c.aug._asdict())) for c in calls]
            s2.update(d_fake_g=prog[0], d_real=prog[1], d_fake=prog[2])
        return record, RenderDraws(**rd), Step2Draws(**s2)

    def __call__(self, state, batch, cfg, epoch=0.0, draws=None, generator=None, step2_draws=None, grad_hook=None):
        kwargs = dict(generator=generator, grad_hook=grad_hook)
        if draws is not None:
            kwargs["draws"] = draws
        if step2_draws is not None:
            kwargs["step2_draws"] = step2_draws
        record = None
        if len(self.checked) < self.n_check:
            record, kwargs["draws"], kwargs["step2_draws"] = self._check_draws(state, batch)
        self.rays.append(_step_rays(batch))
        with self.spans.span("step"):
            if self.fault is not None:
                state, out = self.fault(self.orig, (state, batch, cfg, epoch), kwargs)
            else:
                state, out = self.orig(state, batch, cfg, epoch, **kwargs)
        if self.events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        loss = out["metrics"]["train/loss"]
        self.losses.append(loss)
        if record is not None:
            record["loss"] = loss.detach().clone()
            if not self.checked:
                record["moments"] = _first_moments(state)
            self.checked.append(record)
            if len(self.checked) == self.n_check:
                self.checked[-1]["params"] = _params(state)
        return state, out


def _named_params(state) -> Dict[str, torch.nn.Parameter]:
    out = {f"{level}.{n}": p for level, m in state.models.items() for n, p in m.named_parameters()}
    if state.discriminator is not None:
        out.update({f"discriminator.{n}": p for n, p in state.discriminator.named_parameters()})
    return out


def _optimizer_of(state, name: str):
    return state.opt_d if name.startswith("discriminator.") else state.opt_g


def _first_moments(state) -> Dict[str, torch.Tensor]:
    """Each parameter's gradient as its optimizer got it, from Adam's first
    moment after one step: ``m = (1 - b1) g``."""
    out = {}
    for name, p in _named_params(state).items():
        opt = _optimizer_of(state, name)
        b1 = opt.param_groups[0]["betas"][0]
        out[name] = opt.state[p]["exp_avg"].detach().clone() / (1.0 - b1)
    return out


def _params(state) -> Dict[str, torch.Tensor]:
    return {k: p.detach().clone() for k, p in _named_params(state).items()}


class TrainLeg:
    """One run of a train cell."""

    def __init__(self, cell, seed: int, device: str, work_dir: str, extra_flags=()):
        from sinnerf_tpu_torch.opt import get_opts
        from sinnerf_tpu_torch.train import loop

        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        cfg, tr = cell.config, cell.traffic
        scene = _scene(cfg, work_dir, seed)
        flags = [*cfg["train_flags"], *tr["flags"], "--root_dir", scene,
                 "--ckpt_dir", os.path.join(work_dir, "ck"), "--log_dir", os.path.join(work_dir, "log"),
                 "--exp_name", cell.name, "--seed", str(seed), "--device", self.device.type, *extra_flags]
        self.hparams = hp = get_opts(flags)
        self.trainer = loop.SinNeRFTrainer(hp)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.weights = draws.weights(gen, vit=hp.vit_weight > 0,
                                     disc_imsize=hp.patch_size if hp.dis_weight > 0 else None)
        st = self.trainer.state
        for level, model in st.models.items():
            model.load_state_dict(self.weights[level])
        if st.vit is not None:
            st.vit.load_state_dict(self.weights["vit"])
        if st.discriminator is not None:
            st.discriminator.load_state_dict(self.weights["discriminator"])
        self.render = {"n_samples": hp.N_samples, "n_importance": hp.N_importance}
        draw_gen = torch.Generator(device=self.device).manual_seed(seed + 1_000_003)
        self.hook = StepHook(loop, int(tr["checked_steps"]), draw_gen, self.render)
        self.spe = self.trainer.steps_per_epoch()
        self.epoch = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm_up(self) -> None:
        """The first steps, the checked ones among them, as one short epoch:
        every kernel and every shape of the cell's steps runs once."""
        self.hook.install()
        self.trainer._run_epoch(self.epoch, max(int(self.cell.traffic["warmup_steps"]), self.hook.n_check))
        self.epoch += 1
        self._sync()

    def window(self, seconds: float, spans: trace.Spans) -> Dict[str, Any]:
        """Whole epochs until ``seconds`` have passed."""
        tr = self.trainer
        timing = self.device.type == "cuda"
        self.hook.reset(spans, timing)
        batches = tr._epoch_batches
        flush = tr._flush_pending_log

        def timed_batches(epoch, spe):
            it = batches(epoch, spe)
            while True:
                with spans.span("sampler"):
                    item = next(it, None)
                if item is None:
                    return
                yield item

        def timed_flush():
            with spans.span("flush"):
                flush()

        if spans.traced:
            tr._epoch_batches, tr._flush_pending_log = timed_batches, timed_flush
        start = None
        if timing:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        with spans.span("window"):
            while True:
                with spans.span("epoch"):
                    tr._run_epoch(self.epoch, self.spe)
                self.epoch += 1
                if time.perf_counter() - t0 >= seconds:
                    break
        window_s = time.perf_counter() - t0
        tr._epoch_batches, tr._flush_pending_log = batches, flush
        steps = len(self.hook.rays)
        losses = torch.stack(self.hook.losses).float().cpu() if steps else torch.zeros(0)
        out = {"window_s": window_s, "steps": steps, "failed": int((~torch.isfinite(losses)).sum()),
               "rays": list(self.hook.rays)}
        if timing:
            marks = [start] + self.hook.events
            out["step_ms"] = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
            out["longest_steps"] = sorted(enumerate(out["step_ms"]), key=lambda x: -x[1])[:8]
        return out

    def end_to_end(self, w: Dict[str, Any]) -> Dict[str, float]:
        """The step time over the whole window and, on the card, the 95th
        percentile (nearest rank) of the steps' lengths."""
        out = {"train_step_ms": 1e3 * w["window_s"] / w["steps"]}
        if "step_ms" in w:
            step_ms = sorted(w["step_ms"])
            out["train_step_p95_ms"] = step_ms[math.ceil(0.95 * len(step_ms)) - 1]
        return out

    def counters(self) -> Dict[str, Any]:
        return {"dtype": self.hparams.compute_dtype, **self.render}

    # ------------------------------------------------------------ the check
    def free(self) -> Dict[str, Any]:
        """Drop the program's state; keep what the check reads (on the host)."""
        self.hook.remove()
        rec = self.hook.checked
        prog = {
            "losses": [float(r["loss"]) for r in rec],
            "grads": {k: v.cpu() for k, v in rec[0]["moments"].items()},
            "change": {k: (v - self._initial(k)).cpu() for k, v in rec[-1]["params"].items()},
        }
        hp = self.hparams
        self.check_inputs = {
            "records": [{k: v for k, v in r.items() if k not in ("moments", "params", "loss")} for r in rec],
            "white_back": self.trainer.train_dataset.white_back,
            "patch_size": hp.patch_size,
        }
        if self.trainer.writer is not None:
            self.trainer.writer.close()
        self.trainer = None
        self.hook.checked = []
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return prog

    def _initial(self, name: str) -> torch.Tensor:
        level, leaf = name.split(".", 1)
        return self.weights[level][leaf]

    def step_config(self, precision: Optional[str] = None) -> StepConfig:
        """The reference's step at ``precision``, by default the
        configuration's: the NeRF's products on bf16-rounded inputs when the
        cell trains in bfloat16."""
        hp = self.hparams
        if precision is None and hp.compute_dtype == "bfloat16":
            precision = "bfloat16"
        return StepConfig(
            render=Settings(n_samples=hp.N_samples, n_importance=hp.N_importance, perturb=hp.perturb,
                            noise_std=hp.noise_std, white_back=self.cell.config["white_back"], precision=precision),
            blender="blender" in hp.dataset_name, dtu=hp.dataset_name == "dtu_proj", dloss=hp.dloss,
            depth_weight=hp.depth_weight, vit_weight=hp.vit_weight, dis_weight=hp.dis_weight,
            proj_weight=hp.proj_weight, depth_smooth_weight=hp.depth_smooth_weight)

    def reference(self, precision: Optional[str] = None, halve: bool = False) -> Dict[str, Any]:
        """The reference's readings of the checked steps, from the same
        weights, batches and draws.  ``precision`` and ``halve`` (half of
        each random-ray bundle left out, the means over the rest) are the
        controls' and faults' readings."""
        dev, hp, cfg = self.device, self.hparams, self.step_config(precision)
        # the configuration's precision for the plain parts: PyTorch's
        # defaults, float32 matmuls and the discriminator's convolutions in TF32
        with plain_matmuls(conv_tf32=True):
            models = {}
            for level in ("coarse", "fine"):
                models[level] = RefNeRF().to(dev)
                models[level].load_state_dict(self.weights[level])
            vit = disc = None
            if hp.vit_weight > 0:
                vit = frozen(RefViT().to(dev))
                vit.load_state_dict(self.weights["vit"])
            params = {f"{lvl}.{n}": p for lvl, m in models.items() for n, p in m.named_parameters()}
            opt_g = Adam(list(params.values()), lr=hp.lr)
            opt_d = None
            if hp.dis_weight > 0:
                disc = RefDiscriminator(imsize=hp.patch_size, generator=torch.Generator()).to(dev)
                disc.load_state_dict(self.weights["discriminator"])
                d_params = {f"discriminator.{n}": p for n, p in disc.named_parameters()}
                params.update(d_params)
                opt_d = Adam(list(d_params.values()), lr=hp.lr * D_RATE)
            records = self.check_inputs["records"]
            b = records[0]["batch"]["rays"].shape[0]
            ref_feature = torch.zeros((b, 384), device=dev) if vit is not None else None
            out = {"losses": []}
            for i, rec in enumerate(records):
                batch, rd = rec["batch"], rec["render"]
                if halve:
                    batch, rd = _halved(batch, rd)
                for opt in (opt_g, opt_d):
                    if opt is not None:
                        opt.zero_grad()
                refresh = None
                if vit is not None:
                    refresh = torch.ones(b, dtype=torch.bool) if i == 0 else rec["refresh"]
                total, ref_feature, d_u = ref_losses(models, batch, cfg, rd, vit=vit, discriminator=disc,
                                                     ref_feature=ref_feature, refresh=refresh,
                                                     d_draws=rec.get("d_calls"))
                total.backward()
                out["losses"].append(float(total.detach()))
                if i == 0:
                    out["grads"] = {k: p.grad.detach().cpu().clone() for k, p in params.items()}
                opt_g.step()
                if opt_d is not None:
                    opt_d.step()
                    disc.set_u(d_u)
            out["change"] = {k: (p.detach() - self._initial(k)).cpu() for k, p in params.items()}
        return out

    def numbers(self, prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
        return judge.train_numbers(prog, ref)


def _halved(batch: Dict[str, torch.Tensor], rd: Dict[str, torch.Tensor]):
    """The batch with the second half of each item's random-ray bundles
    (``rays`` and ``rays_proj``) left out, and the render draws of the rays
    that remain."""
    b, n, p, n_proj = (batch["rays"].shape[0], batch["rays"].shape[1], batch["depth_ray"].shape[1],
                       batch["rays_proj"].shape[1])
    out = dict(batch)
    for k in ("rays", "rgbs", "depth"):
        out[k] = batch[k][:, : n // 2]
    for k in ("rays_proj", "depth_proj"):
        out[k] = batch[k][:, : n_proj // 2]
    # each draw's rows in render order: the bundles rays, depth_ray,
    # rays_full, rays_proj, each item-major
    kept = {}
    for k, v in rd.items():
        parts, start = [], 0
        for rows, keep in ((n, n // 2), (p, p), (p, p), (n_proj, n_proj // 2)):
            parts.append(v[start: start + b * rows].reshape(b, rows, -1)[:, :keep].reshape(b * keep, -1))
            start += b * rows
        kept[k] = torch.cat(parts)
    return out, kept


def run_in_tmp(fn):
    """``fn(work_dir)`` in a fresh directory under ``TMPDIR``, removed after."""
    with tempfile.TemporaryDirectory(prefix="bench-") as work:
        return fn(work)
