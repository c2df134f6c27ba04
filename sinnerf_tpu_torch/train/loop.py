"""The training loop: the reference's pytorch-lightning ``Trainer`` and
``SinNeRF`` module as one explicit loop.

Counterpart of ``sinnerf_tpu/train/loop.py`` (reference
``models/sinnerf.py:124-210`` for the system, ``train.py:44-62`` for the
fit loop, ``models/sinnerf.py:556-586`` for validation): a sanity
validation of one image, then per epoch the learning rate of
``lr_for_epoch``, ``steps_per_epoch`` sampled steps of ``train_step``
(sampled ``--prefetch_batches`` steps at a time, :410-452), and every
``check_val_every_n_epoch`` epochs a validation over the val split through
``render_chunked`` and a checkpoint (top-2 on val/psnr plus ``last``).
Scalars and images go to TensorBoard under the JAX package's tags every 10
steps, written one log step later (:454-521), when a TensorBoard writer
imports; without one the writer is None.

Every training set of the registry trains: Blender's rot3d and proj
(``--patch_size``), LLFF and DTU (``--patch_size_x`` x ``--patch_size_y``),
each taking the JAX trainer's flags (:63-110).  The Step-2 extras are built
as the JAX trainer builds them (:129-194): the discriminator at
``imsize=--patch_size`` when ``--dis_weight > 0`` (refused when the training
set's patch is too small for that branch), with its own optimizer at a
constant 0.2x the learning rate; the frozen ViT when ``--vit_weight > 0``
and the VGG trunk for ``--patch_loss l2_vgg``, from ``--vit_weights`` /
``--vgg_weights``, or random from the seed under
``--allow_random_pretrained`` (refused otherwise).

Data parallelism (JAX :103-116, 213-236, 344-345, 470-500, 557-600): with
``--num_gpus N`` the trainer runs on each of N ranks (``parallel/ddp.py``
starts them), ``--batch_size`` items per rank and a global batch of
``batch_size * N``.  Every rank builds the same state from the seed or the
checkpoint, samples its own items of the global batch with generators of
its own, and all-reduces the gradients before the optimizers step; the
Step-2 ``()`` draws come from a generator seeded alike on every rank.  The
ViT cache holds the rank's rows.  Validation renders each image sharded
over the ranks.  Rank 0 alone writes TensorBoard (scalars reduced to the
global batch's, its item 0's images) and checkpoints.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from sinnerf_tpu_torch.data import dataset_dict
from sinnerf_tpu_torch.models.discriminator import Discriminator, export_torch_discriminator_state, output_side
from sinnerf_tpu_torch.models.nerf import nerf_from_state, random_params, state_dict_from_jax
from sinnerf_tpu_torch.models.vgg import load_vgg
from sinnerf_tpu_torch.models.vit import EMBED_DIM, load_vit
from sinnerf_tpu_torch.parallel import ddp
from sinnerf_tpu_torch.render.renderer import RenderSettings, pick_val_tile, render_chunked, render_chunked_sharded
from sinnerf_tpu_torch.train.checkpoints import (
    TopKCheckpointManager,
    load_torch_discriminator,
    load_torch_nerf_checkpoint,
    nerf_state_dict,
    read_checkpoint,
)
from sinnerf_tpu_torch.train.optimizers import get_learning_rate, get_optimizer, lr_for_epoch, set_lr
from sinnerf_tpu_torch.train.step import Step2Draws, TrainConfig, TrainState, batch_coins, refresh_coins, train_step
from sinnerf_tpu_torch.utils.device import resolve_device
from sinnerf_tpu_torch.utils.metrics import psnr as psnr_metric
from sinnerf_tpu_torch.utils.visualization import visualize_depth

D_LR_RATE = 0.2  # the discriminator's constant share of --lr (sinnerf.py:208)
RANK_SEED_STRIDE = 104729  # rank r's sampler, render and host generators: the seed + r * this
# the images of item 0 that the log writes (``_log_images``)
LOG_IMAGE_KEYS = ("real_patch", "rgb_coarse_full", "rgb_fine_full", "side_rgb", "rgb_coarse_side", "rgb_fine_side",
                  "depth_coarse_side", "depth_fine_side", "warp_depth")


def build_render_settings(hparams: Any, white_back: bool) -> RenderSettings:
    return RenderSettings(
        n_samples=hparams.N_samples,
        n_importance=hparams.N_importance,
        use_disp=hparams.use_disp,
        perturb=hparams.perturb,
        noise_std=hparams.noise_std,
        white_back=white_back,
        compute_dtype=hparams.compute_dtype,
        mlp_impl=hparams.mlp_impl,
    )


def _check_supported(hparams: Any, world: int) -> None:
    if hparams.num_gpus != world:
        raise ValueError(f"--num_gpus {hparams.num_gpus} runs {hparams.num_gpus} ranks, this trainer is one of "
                         f"{world}: start it through `python -m sinnerf_tpu_torch.train` (or torchrun), which "
                         "starts one process per card")
    if hparams.loss_type in ("l2_vgg", "l2_ssim"):
        # the random-ray loss feeds flat (N, 3) bundles, on which the
        # reference's VGG and SSIM losses crash (losses.py:105, 129)
        raise ValueError(f"--loss_type {hparams.loss_type} is unsupported (as in the reference, where it "
                         f"crashes on ray bundles); use --patch_loss {hparams.loss_type} for the patch term")
    allow_random = hparams.allow_random_pretrained
    if hparams.vit_weight > 0 and not hparams.vit_weights and not allow_random:
        raise ValueError("--vit_weight > 0 requires --vit_weights <path to DINO ViT-S/16 torch weights>: without "
                         "them the semantic loss compares against a RANDOM ViT and is pure noise. Pass "
                         "--allow_random_pretrained to override (tests only).")
    if hparams.patch_loss == "l2_vgg" and not hparams.vgg_weights and not allow_random:
        raise ValueError("--patch_loss l2_vgg requires --vgg_weights <path to torchvision VGG16 weights>: without "
                         "them the perceptual loss uses a RANDOM VGG. Pass --allow_random_pretrained to override "
                         "(tests only).")


def _check_discriminator_patch(hparams: Any, cfg) -> None:
    """D's branch is ``--patch_size``'s; the patches it sees are the
    training set's own (Blender: ``--patch_size``, LLFF and DTU:
    ``--patch_size_x`` x ``--patch_size_y``)."""
    side = min(cfg.psx, cfg.psy)
    if hparams.dis_weight > 0 and output_side(hparams.patch_size, side) < 1:
        raise ValueError(f"--dis_weight > 0: a {side}-pixel patch is too small for the discriminator's "
                         f"imsize={hparams.patch_size} branch")


def _host_copy(tree):
    """``tree`` with every tensor copied to the host: a ``state_dict``'s
    tensors alias the live ones."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


def _start_host_copy(tree):
    """Start copying the tensors of ``tree`` (a dict of dicts) to the host:
    (the copies, a CUDA event recorded after them, or None where nothing
    lives on a card).  A card's tensors go to pinned memory without
    waiting; on the CPU the copies are plain."""
    def copy(t):
        t = t.detach()
        if not t.is_cuda:
            return t.clone()
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)

    out = {name: {k: copy(v) for k, v in part.items()} for name, part in tree.items()}
    event = None
    if any(v.is_cuda for part in tree.values() for v in part.values()):
        event = torch.cuda.Event()
        event.record()
    return out, event


def _make_writer(log_dir: str):
    """A TensorBoard writer, or None when no TensorBoard package imports."""
    for module in ("tensorboardX", "torch.utils.tensorboard"):
        try:
            return __import__(module, fromlist=["SummaryWriter"]).SummaryWriter(log_dir)
        except Exception:
            continue
    return None


class SinNeRFTrainer:
    def __init__(self, hparams: Any, rank: int = 0, world: int = 1):
        """Rank ``rank`` of ``world`` (``--num_gpus``); at ``world > 1`` the
        process group is up and this process's card is current."""
        _check_supported(hparams, world)
        self.hparams = hparams
        self.rank, self.world = rank, world
        self.device = ddp.rank_device(resolve_device(hparams.device).type)
        seed = hparams.seed
        if hparams.dataset_name not in dataset_dict:
            raise ValueError(f"--dataset_name {hparams.dataset_name!r} is not a known dataset; "
                             f"choose one of {sorted(dataset_dict)}")
        ds_cls = dataset_dict[hparams.dataset_name]
        ds_kwargs = dict(vars(hparams))
        ds_kwargs["img_wh"] = tuple(hparams.img_wh)
        ds_kwargs["device"] = self.device
        root = ds_kwargs.pop("root_dir")
        self.train_dataset = ds_cls(root, split="train", **ds_kwargs)
        _check_discriminator_patch(hparams, self.train_dataset.cfg)
        self.val_dataset = ds_cls(root, split="val", **ds_kwargs)

        self.render_settings = build_render_settings(hparams, self.train_dataset.white_back)
        self.cfg = TrainConfig(
            render=self.render_settings,
            dataset_name=hparams.dataset_name,
            loss_type=hparams.loss_type,
            patch_loss=hparams.patch_loss,
            dloss=hparams.dloss,
            depth_weight=hparams.depth_weight,
            vit_weight=hparams.vit_weight,
            dis_weight=hparams.dis_weight,
            proj_weight=hparams.proj_weight,
            depth_smooth_weight=hparams.depth_smooth_weight,
            depth_anneal=hparams.depth_anneal,
            load_depth=hparams.load_depth,
        )
        self.batch_size = hparams.batch_size  # this rank's items per step
        self.global_batch_size = hparams.batch_size * world

        # ---- models: reference-width NeRFs drawn from the seed -------------
        rng = np.random.default_rng(seed)
        models = {level: nerf_from_state(state_dict_from_jax(random_params(rng))) for level in ("coarse", "fine")}
        init = torch.Generator().manual_seed(seed + 3)  # D, ViT and VGG when random
        disc = Discriminator(imsize=hparams.patch_size, generator=init) if hparams.dis_weight > 0 else None
        if hparams.pt_model:  # warm start (train.py:22-33)
            warm = load_torch_nerf_checkpoint(hparams.pt_model, hparams.prefixes_to_ignore or ())
            for level, sd in warm.items():
                models[level].load_state_dict(sd)
            if disc is not None and not hparams.nerf_only:
                # the reference's whole-system load (train.py:31-33) takes D
                # too when the checkpoint has one; --nerf_only keeps it fresh
                load_torch_discriminator(hparams.pt_model, disc, hparams.prefixes_to_ignore or ())
        models = {k: m.to(self.device) for k, m in models.items()}
        params = [p for m in models.values() for p in m.parameters()]
        self.state = TrainState(models=models, opt_g=get_optimizer(hparams, params))
        st = self.state
        if disc is not None:
            st.discriminator = disc.to(self.device)
            st.opt_d = get_optimizer(hparams, disc.parameters(), rate=D_LR_RATE)
        if hparams.vit_weight > 0:
            st.vit = load_vit(hparams.vit_weights, init).to(self.device)
            # one cached CLS feature per item of this rank, valid after its first refresh
            st.ref_feature = torch.zeros((self.batch_size, EMBED_DIM), device=self.device)
            st.ref_feature_valid = torch.zeros((self.batch_size,), dtype=torch.bool)
        if hparams.patch_loss == "l2_vgg":
            st.vgg = load_vgg(hparams.vgg_weights, init).to(self.device)

        self.start_epoch = 0
        best = None
        if hparams.ckpt_path:  # full resume (train.py:46)
            best = self._resume(hparams.ckpt_path)
        # draws: the sampler's and the ViT refresh coins on the host, the
        # render's and the discriminator's on the device, each rank its own;
        # over several ranks the discriminator calls' () draws on the host,
        # alike on every rank (JAX draws them once for the global batch)
        own = seed + 7919 * self.start_epoch + RANK_SEED_STRIDE * rank
        self.sample_generator = torch.Generator().manual_seed(own)
        self.render_generator = torch.Generator(device=self.device).manual_seed(own + 1)
        self.host_generator = torch.Generator().manual_seed(own + 2)
        self.batch_generator = torch.Generator().manual_seed(seed + 5 + 7919 * self.start_epoch)
        self.grad_hook = ddp.gradient_hook(world) if world > 1 else None

        self.ckpt_manager = self.writer = None
        if rank == 0:
            self.ckpt_manager = TopKCheckpointManager(os.path.join(hparams.ckpt_dir, hparams.exp_name), top_k=2,
                                                      best=best)
            self.writer = _make_writer(os.path.join(hparams.log_dir, hparams.exp_name))
        self._pending_log = None  # (host copies and their event, step, lr) of the last log step
        self.epoch_log: List[Tuple[int, int, float]] = []  # (epoch, steps, seconds) of each training epoch
        self.val_log: List[Tuple[int, float]] = []  # (epoch, val PSNR) of each validation
        self.lr_log: List[Tuple[int, float]] = []  # (epoch, G's learning rate as its optimizer holds it) per epoch

    # ------------------------------------------------------------------ io
    def _resume(self, path: str):
        """Models, optimizer states (``[opt_g, opt_d]``), the
        discriminator and its ``u``, the ViT cache and its flags, step count
        and top-k ranking of a training checkpoint; training continues at
        the epoch after the saved one (the save runs after its epoch)."""
        blob = read_checkpoint(path)
        st = self.state
        for level, sd in load_torch_nerf_checkpoint(path).items():
            st.models[level].load_state_dict(sd)
        opt_states = blob.get("optimizer_states") or []
        for opt, saved in zip((st.opt_g, st.opt_d), opt_states):
            if opt is not None and saved:
                opt.load_state_dict(saved)
        if st.discriminator is not None:
            load_torch_discriminator(path, st.discriminator)
        if st.vit is not None and blob.get("ref_feature") is not None:
            # the checkpoint holds the global batch's rows; this rank takes its own
            rows = slice(self.rank * self.batch_size, (self.rank + 1) * self.batch_size)
            st.ref_feature = blob["ref_feature"][rows].to(self.device)
            st.ref_feature_valid = blob["ref_feature_valid"][rows].cpu()
        st.step = int(blob.get("global_step", 0))
        saved_epoch = blob.get("epoch")
        self.start_epoch = 0 if saved_epoch is None else int(saved_epoch) + 1
        return blob.get("ckpt_best")

    def _save(self, epoch: int, val_psnr: float) -> None:
        """Rank 0 writes the checkpoint (the ViT cache gathered to the global
        batch's rows first, on every rank); the others wait for it."""
        st = self.state
        ref_feature = ref_valid = None
        if st.ref_feature is not None:
            ref_feature = ddp.all_gather_rows(st.ref_feature.detach(), self.world)
            ref_valid = ddp.all_gather_rows(st.ref_feature_valid.cpu(), self.world)
        if self.rank == 0:
            self._write(epoch, val_psnr, ref_feature, ref_valid)
        ddp.barrier()

    def _write(self, epoch: int, val_psnr: float, ref_feature, ref_valid) -> None:
        st = self.state
        state_dict = nerf_state_dict({k: m.state_dict() for k, m in st.models.items()})
        if st.discriminator is not None:
            state_dict.update(export_torch_discriminator_state(st.discriminator, prefix="D."))
        blob = {
            "state_dict": state_dict,
            "optimizer_states": [_host_copy(opt.state_dict()) for opt in (st.opt_g, st.opt_d) if opt is not None],
            "epoch": epoch,
            "global_step": st.step,
            "val_psnr": val_psnr,
            "hparams": {k: v for k, v in vars(self.hparams).items()
                        if isinstance(v, (int, float, str, bool, list, tuple))},
        }
        if ref_feature is not None:
            blob["ref_feature"] = ref_feature.detach().cpu().clone()
            blob["ref_feature_valid"] = ref_valid.cpu().clone()
        self.ckpt_manager.save(blob, epoch, val_psnr)

    # --------------------------------------------------------------- train
    def steps_per_epoch(self) -> int:
        """Optimizer steps per epoch: the items over the global batch
        (JAX ``steps_per_epoch`` :360)."""
        return max(1, math.ceil(len(self.train_dataset) / self.global_batch_size))

    def fit(self) -> float:
        """Train and validate; returns the best val PSNR.  ``--profile``
        writes a ``torch.profiler`` trace of the fit into the log dir (the
        reference profiles single-GPU runs, ``train.py:59``)."""
        if not self.hparams.profile:
            return self._fit()
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        log_dir = os.path.join(self.hparams.log_dir, self.hparams.exp_name)
        os.makedirs(log_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            best = self._fit()
        if self.rank == 0:
            prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        return best

    def _fit(self) -> float:
        hp = self.hparams
        best_psnr = -1.0
        self.validate(self.start_epoch, max_batches=1, log=False)  # sanity val (train.py:54)
        spe = self.steps_per_epoch()
        for epoch in range(self.start_epoch, hp.num_epochs):
            self._run_epoch(epoch, spe)
            if (epoch + 1) % hp.check_val_every_n_epoch == 0:
                val_psnr = self.validate(epoch)
                best_psnr = max(best_psnr, val_psnr)
                self.val_log.append((epoch, val_psnr))
                self._save(epoch, val_psnr)
        return best_psnr

    def _epoch_batches(self, epoch: int, spe: int):
        """Yield ``(i, batch)`` for the epoch's ``spe`` steps (JAX :410).
        This rank's items of the global batch are those of step ``(epoch *
        spe + i) * world + rank`` in steps of batch_size (at world 1, the
        step's items).  With ``--prefetch_batches K > 1`` the steps are
        sampled K at a time by ``sample_many``, in groups that end at the
        epoch's end (the tail group is ``spe % K``; a group of one takes
        ``sample``): the same batches and generator state as step by step,
        with at most one read of the device per group."""
        k_pref = max(1, self.hparams.prefetch_batches)
        ds, gen = self.train_dataset, self.sample_generator
        i = 0
        while i < spe:
            k = min(k_pref, spe - i)
            steps = [(epoch * spe + i + j) * self.world + self.rank for j in range(k)]
            if k == 1:
                yield i, ds.sample(steps[0], self.batch_size, gen)
            else:
                batches = ds.sample_many(steps, self.batch_size, gen)
                for j in range(k):
                    yield i + j, {name: v[j] for name, v in batches.items()}
            i += k

    def _run_epoch(self, epoch: int, spe: int) -> None:
        """One epoch at the epoch's learning rate; scalars and images every
        10 steps, written one log step later (JAX :454-521): the host copy
        of a step's payload starts at its step and is read at the next log
        step or the epoch's end, so that logging does not wait for the
        device."""
        lr = lr_for_epoch(self.hparams, epoch)
        set_lr(self.state.opt_g, lr)
        self.lr_log.append((epoch, get_learning_rate(self.state.opt_g)))
        if self.state.opt_d is not None:
            # the schedule binds to G's optimizer only (sinnerf.py:202-210):
            # D trains at a constant 0.2x the base lr, re-asserted every epoch
            set_lr(self.state.opt_d, self.hparams.lr, rate=D_LR_RATE)
        t0 = time.perf_counter()
        for _, batch in self._epoch_batches(epoch, spe):
            step2_draws = Step2Draws()
            if self.world > 1 and self.state.discriminator is not None:
                step2_draws = batch_coins(self.cfg.dloss, self.batch_generator, self.device)
            if self.state.vit is not None:
                step2_draws = step2_draws._replace(refresh=refresh_coins(self.batch_size, self.host_generator))
            self.state, out = train_step(self.state, batch, self.cfg, float(epoch), generator=self.render_generator,
                                         step2_draws=step2_draws, grad_hook=self.grad_hook)
            if self.state.step % 10 == 0:
                metrics = ddp.reduce_metrics(out["metrics"], self.world)  # every rank: a collective
                if self.writer:
                    images = {k: out["images"][k][0] for k in LOG_IMAGE_KEYS}
                    payload = _start_host_copy({"metrics": metrics, "images": images})
                    self._flush_pending_log()
                    self._pending_log = (payload, self.state.step, lr)
        self._flush_pending_log()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.epoch_log.append((epoch, spe, dt))
        if self.writer:
            self.writer.add_scalar("train/epoch_time", dt, epoch)

    def _flush_pending_log(self) -> None:
        """Write the pending payload under the step and learning rate it
        came from, once its host copy has landed."""
        if self._pending_log is None:
            return
        (tree, done), step, lr = self._pending_log
        self._pending_log = None
        if done is not None:
            done.synchronize()
        self._log_scalars(tree["metrics"], step, lr)
        self._log_images(tree["images"], step)

    def _log_scalars(self, metrics: Dict[str, torch.Tensor], step: int, lr: float) -> None:
        self.writer.add_scalar("lr", lr, step)
        for k, v in metrics.items():
            self.writer.add_scalar(k, float(v), step)

    def _log_images(self, images: Dict[str, torch.Tensor], step: int) -> None:
        """Item 0's images under the JAX package's tags (reference
        ``sinnerf.py:413-444``): 'train/images' [real, coarse, fine] and
        'train/images_side'."""
        def img(k):
            return images[k].float().numpy()

        stack = np.stack([img("real_patch"), img("rgb_coarse_full"), img("rgb_fine_full")])
        self.writer.add_images("train/images", np.clip(stack, 0, 1), step)
        side = np.stack([img("side_rgb"), img("rgb_coarse_side"), img("rgb_fine_side"),
                         visualize_depth(img("depth_coarse_side")), visualize_depth(img("depth_fine_side")),
                         visualize_depth(img("warp_depth"))])
        self.writer.add_images("train/images_side", np.clip(side, 0, 1), step)

    # ----------------------------------------------------------------- val
    def validate(self, epoch: int, max_batches: Optional[int] = None, log: bool = True) -> float:
        """Mean PSNR of the fine render over the val split (JAX ``validate``
        :557), rendered in tiles of ``pick_val_tile`` rays."""
        hp = self.hparams
        w, h = hp.img_wh
        n = self.val_dataset.val_len()
        if max_batches is not None:
            n = min(n, max_batches)
        tile = pick_val_tile(w * h, hp.chunk, self.world)
        psnrs = []
        for i in range(n):
            item = self.val_dataset.val_item(i)
            rays = torch.from_numpy(item["rays"]).to(self.device)
            if self.world > 1:  # every rank gets the whole image, so the same PSNR
                results = render_chunked_sharded(self.state.models, rays, self.render_settings, self.rank,
                                                 self.world, tile=tile, keys=("rgb_fine", "depth_fine"))
            else:
                results = render_chunked(self.state.models, rays, self.render_settings, tile=tile)
            if "rgbs" not in item:
                continue
            gt = torch.from_numpy(item["rgbs"]).to(self.device)
            psnrs.append(psnr_metric(results["rgb_fine"], gt))
            if log and self.writer and i % 5 == 0:
                pred = results["rgb_fine"].reshape(h, w, 3).cpu().numpy()
                depth = visualize_depth(results["depth_fine"].reshape(h, w).cpu().numpy())
                stack = np.stack([item["rgbs"].reshape(h, w, 3).transpose(2, 0, 1), pred.transpose(2, 0, 1), depth])
                self.writer.add_images("val/GT_pred_depth", np.clip(stack, 0, 1), self.state.step)
        mean_psnr = float(torch.stack(psnrs).mean()) if psnrs else 0.0
        if log and self.writer:
            self.writer.add_scalar("val/psnr", mean_psnr, epoch)
        return mean_psnr


def run(rank: int, world: int, hparams) -> SinNeRFTrainer:
    """Rank ``rank`` of ``world``: train with ``hparams``; returns the
    trainer after its fit, with the best val PSNR in ``trainer.best_psnr``
    (rank 0 prints it)."""
    trainer = SinNeRFTrainer(hparams, rank, world)
    trainer.best_psnr = trainer.fit()
    if trainer.writer:
        trainer.writer.close()
    if rank == 0:
        print(f"best val/psnr: {trainer.best_psnr:.3f}")
    return trainer


def summary(trainer: SinNeRFTrainer) -> Dict[str, Any]:
    """What a rank's run leaves for the process that started it."""
    return dict(rank=trainer.rank, world=trainer.world, best_psnr=trainer.best_psnr, epoch_log=trainer.epoch_log,
                val_log=trainer.val_log, lr_log=trainer.lr_log, steps_per_epoch=trainer.steps_per_epoch(),
                step=trainer.state.step)


def run_rank(rank: int, world: int, hparams) -> Dict[str, Any]:
    """``run``'s ``summary``: what the train CLI launches on each rank
    (defined here: a spawned process does not import a package's
    ``__main__``)."""
    return summary(run(rank, world, hparams))
