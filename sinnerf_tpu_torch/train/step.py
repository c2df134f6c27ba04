"""One training step: render, losses, one backward, the G and D updates.

Counterpart of ``sinnerf_tpu/train/step.py`` (reference
``SinNeRF.training_step``, ``models/sinnerf.py:271-554``).  The four ray
bundles of a batch (random rays, reference-view patch, pseudo-view patch,
projected rays) are concatenated and rendered in one pass; the losses are
summed with the reference's weights (``sinnerf.py:492-509``):

    total = loss_g.tot + dis_weight * (loss_g_adv + loss_d)
          + depth_weight * loss_depth
          + proj_weight * depth_weight * loss_side_depth
          + vit_weight * loss_vit + depth_smooth_weight * loss_depth_smooth

Masked depth losses and the ViT's cached reference feature are per item, as
in the JAX package.  The Step-2 extras: the DINO-ViT CLS loss on the
pseudo-view patch against a per-item cached feature of the real patch,
refreshed with probability 0.05 per item (``sinnerf.py:272-275, 332-338``);
the PatchGAN's generator and discriminator terms (``sinnerf.py:445-487``),
which read D in the JAX call order, threading its spectral-norm ``u``
through the calls: the fake patch on frozen weights, for ``relavistic`` the
augmented real patch on frozen weights, the real patch, the detached fake
patch; and the ``l2_vgg`` patch loss.  One ``backward`` gives the G and D
gradients, then each optimizer steps once.  Metric tags and the ``images``
entries are the JAX package's.

Every random draw can be passed in: the render's (``RenderDraws``) and the
Step-2 losses' (``Step2Draws``); a draw not passed comes from the
``torch.Generator`` given, but the ViT refresh coins, which are host tensors
(``refresh_coins``; torch's default host generator when not passed), so that
the step decides whether to run the ViT on the real patch without reading
the device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from sinnerf_tpu_torch.losses.depth import (
    inverse_depth_smoothness_loss,
    smooth_l1_masked,
    smooth_l1_masked_per_item,
)
from sinnerf_tpu_torch.losses.gan import d_loss as gan_d_loss
from sinnerf_tpu_torch.losses.gan import g_loss as gan_g_loss
from sinnerf_tpu_torch.losses.photometric import L2_SSIM_LOSS, L2_VGG_LOSS, loss_dict
from sinnerf_tpu_torch.models.diffaug import SKIP_PROB, DiffAugDraws, coin, diff_augment
from sinnerf_tpu_torch.models.discriminator import DCallDraws, Discriminator
from sinnerf_tpu_torch.models.nerf import NeRF
from sinnerf_tpu_torch.models.vgg import VGG16Features
from sinnerf_tpu_torch.models.vit import EMBED_DIM, ViT, vit_cls
from sinnerf_tpu_torch.render.renderer import RenderSettings, render_rays
from sinnerf_tpu_torch.utils.metrics import psnr
from sinnerf_tpu_torch.utils.spans import span

POLICY = "color,cutout"  # DiffAugment inside the discriminator (sinnerf.py:445-487)
VIT_REFRESH_PROB = 0.05  # per item and step, the cached ViT feature's refresh (sinnerf.py:273)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Per-run configuration; fields map 1:1 onto the ``opt.py`` flags, as
    the JAX ``TrainConfig`` does."""

    render: RenderSettings
    dataset_name: str = "blender_ray_patch_1image_rot3d"
    loss_type: str = "mse"
    patch_loss: str = "mse"
    dloss: str = "hinge"  # opt.py:98
    depth_weight: float = 0.05
    vit_weight: float = 0.0
    dis_weight: float = 0.0
    proj_weight: float = 1.0
    depth_smooth_weight: float = 0.0
    depth_anneal: bool = False
    load_depth: bool = True

    @property
    def is_dtu(self) -> bool:
        return self.dataset_name == "dtu_proj"

    @property
    def is_blender(self) -> bool:
        return "blender" in self.dataset_name


@dataclasses.dataclass
class TrainState:
    models: Dict[str, NeRF]  # {'coarse', 'fine'}, updated in place
    opt_g: torch.optim.Optimizer
    step: int = 0
    discriminator: Optional[Discriminator] = None  # updated in place, its u included
    opt_d: Optional[torch.optim.Optimizer] = None
    vit: Optional[ViT] = None  # frozen
    vgg: Optional[VGG16Features] = None  # frozen (the l2_vgg patch loss)
    ref_feature: Optional[torch.Tensor] = None  # (B, 384) cached CLS features, on the models' device
    ref_feature_valid: Optional[torch.Tensor] = None  # (B,) bool on the host: False refreshes that item


class RenderDraws(NamedTuple):
    """The render's random draws over the N concatenated rays of a batch, as
    ``render_rays`` takes them."""

    perturb_u: Optional[torch.Tensor] = None     # (N, n_samples) uniforms
    noise_coarse: Optional[torch.Tensor] = None  # (N, n_samples) normals
    pdf_u: Optional[torch.Tensor] = None         # (N, n_importance) uniforms
    noise_fine: Optional[torch.Tensor] = None    # (N, n_samples + n_importance) normals


class Step2Draws(NamedTuple):
    """The Step-2 losses' random draws: the ViT refresh coins and, per
    discriminator call in the JAX call order, its coin and DiffAugment
    draws (``DCallDraws``)."""

    refresh: Optional[torch.Tensor] = None    # (B,) bool on the host: refresh the item's cached feature
    d_fake_g: DCallDraws = DCallDraws()       # G term: frozen D on the fake patch
    real_g_coin: Optional[torch.Tensor] = None  # relavistic: () bool, augment the real patch before D
    real_g_aug: DiffAugDraws = DiffAugDraws()   # relavistic: that augmentation's draws
    d_real_g: DCallDraws = DCallDraws()       # relavistic: frozen D on the (augmented) real patch
    d_real: DCallDraws = DCallDraws()         # D term: D on the real patch
    d_fake: DCallDraws = DCallDraws()         # D term: D on the detached fake patch


def refresh_coins(b: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(b,) bool host tensor: each item's coin of p = VIT_REFRESH_PROB to
    refresh its cached ViT feature this step; ``generator`` is a host one."""
    return torch.rand((b,), generator=generator) < VIT_REFRESH_PROB


def batch_coins(dloss: str, generator: torch.Generator, device) -> Step2Draws:
    """The () draws of a step's discriminator calls, in the JAX call order:
    each call's coin and its DiffAugment ``skip`` (and for ``relavistic``
    the outer augmentation's coin and ``skip``), drawn on the host from
    ``generator`` and moved to ``device``.  JAX draws each once for the
    global batch; under data parallelism every rank seeds ``generator``
    alike, so that its ranks agree on them.  The per-item draws stay the
    rank's own."""
    def flip(p: float = 0.5) -> torch.Tensor:
        return (torch.rand((), generator=generator) < p).to(device)

    def call() -> DCallDraws:
        c = flip()
        return DCallDraws(coin=c, aug=DiffAugDraws(skip=flip(SKIP_PROB)))

    d_fake_g = call()
    relavistic = {}
    if dloss == "relavistic":
        c = flip()
        relavistic = dict(real_g_coin=c, real_g_aug=DiffAugDraws(skip=flip(SKIP_PROB)), d_real_g=call())
    d_real = call()
    return Step2Draws(d_fake_g=d_fake_g, d_real=d_real, d_fake=call(), **relavistic)


def _check_supported(cfg: TrainConfig, discriminator, vit, vgg) -> None:
    if cfg.loss_type in (L2_VGG_LOSS, L2_SSIM_LOSS):
        raise ValueError(f"loss_type {cfg.loss_type!r} is unsupported on ray bundles (as in the reference, "
                         "where it crashes); use it as patch_loss")
    if cfg.vit_weight > 0 and vit is None:
        raise ValueError("vit_weight > 0 needs the frozen ViT (TrainState.vit)")
    if cfg.dis_weight > 0 and discriminator is None:
        raise ValueError("dis_weight > 0 needs the discriminator (TrainState.discriminator)")
    if cfg.patch_loss == L2_VGG_LOSS and vgg is None:
        raise ValueError("patch_loss 'l2_vgg' needs the frozen VGG16 trunk (TrainState.vgg)")
    if not cfg.load_depth:
        raise NotImplementedError("reference requires --load_depth (sinnerf.py:502)")


def _flat(x: torch.Tensor, c: int) -> torch.Tensor:
    return x.reshape(-1, c)


def _imgify(flat: torch.Tensor, b: int, c: int, p: int, q: int) -> torch.Tensor:
    """(b*p*q, c) -> (b, c, p, q) like the reference's rearranges."""
    return flat.reshape(b, p, q, c).permute(0, 3, 1, 2)


def compute_losses(
    models: Dict[str, NeRF],
    batch: Dict[str, torch.Tensor],
    cfg: TrainConfig,
    epoch: float = 0.0,
    draws: RenderDraws = RenderDraws(),
    generator: Optional[torch.Generator] = None,
    *,
    discriminator: Optional[Discriminator] = None,
    vit: Optional[ViT] = None,
    vgg: Optional[VGG16Features] = None,
    ref_feature: Optional[torch.Tensor] = None,
    ref_feature_valid: Optional[torch.Tensor] = None,
    step2_draws: Step2Draws = Step2Draws(),
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(total scalar loss, aux) of one batch with the sampler's schema.  aux
    holds ``metrics`` and ``images`` and, for the next step, ``d_u`` (the
    discriminator's power-iteration vectors after this step's calls; its
    buffers are not touched), ``ref_feature`` and ``ref_feature_valid``
    (``ref_feature`` None: zeros, every item invalid)."""
    _check_supported(cfg, discriminator, vit, vgg)
    b = batch["rays"].shape[0]
    psx, psy = batch["real_patch"].shape[-2:]
    loss_fn = loss_dict[cfg.loss_type]
    patch_loss_fn = loss_dict[cfg.patch_loss]
    # the VGG trunk binds to the image-patch loss only: the depth patches
    # (one channel) take the same loss without it (JAX step.py:136-147)
    depth_patch_loss_fn = patch_loss_fn
    if cfg.patch_loss == L2_VGG_LOSS:
        patch_loss_fn = functools.partial(patch_loss_fn, vgg_features=vgg)

    # ---- one render over all 4 bundles ------------------------------------
    bundles = [_flat(batch[k], 8) for k in ("rays", "depth_ray", "rays_full", "rays_proj")]
    with span("step.render"):
        rendered = render_rays(models, torch.cat(bundles, dim=0), cfg.render, *draws, generator=generator)
    offs = [0]
    for r in bundles:
        offs.append(offs[-1] + r.shape[0])
    # random rays, reference-view patch (sinnerf.py:282), pseudo-view patch (:285), projected rays
    results, results_full, results_side, results_proj = (
        {k: v[offs[i] : offs[i + 1]] for k, v in rendered.items()} for i in range(4)
    )

    rgbs = _flat(batch["rgbs"], 3)
    depth = _flat(batch["depth"], 1)[:, 0]
    depth_proj = _flat(batch["depth_proj"], 1)[:, 0]
    rgbs_full_img = _imgify(_flat(batch["depth_ray_rgb"], 3), b, 3, psx, psy)
    real_patch = batch["real_patch"]

    # ---- depth losses on random + projected rays (sinnerf.py:310-319) -----
    loss_depth = (
        smooth_l1_masked(results_proj["depth_fine"], depth_proj, use_mask=False)
        + smooth_l1_masked(results_proj["depth_coarse"], depth_proj, use_mask=False)
        + smooth_l1_masked(results["depth_fine"], depth, use_mask=False)
        + smooth_l1_masked(results["depth_coarse"], depth, use_mask=False)
    )

    # ---- photometric losses -----------------------------------------------
    loss_g = dict(loss_fn(results, rgbs))
    full_imgs, side_imgs = (
        {k: _imgify(res[k], b, 3, psx, psy) for k in ("rgb_coarse", "rgb_fine")}
        for res in (results_full, results_side)
    )
    for k, v in patch_loss_fn(full_imgs, rgbs_full_img).items():
        loss_g[k] = loss_g[k] + v if k in loss_g else v

    # ---- ViT semantic loss on the pseudo view (sinnerf.py:332-338) --------
    zero = torch.zeros((), dtype=loss_depth.dtype, device=loss_depth.device)
    if ref_feature is None:
        ref_feature = torch.zeros((b, EMBED_DIM), dtype=real_patch.dtype, device=real_patch.device)
    if ref_feature_valid is None:
        ref_feature_valid = torch.zeros((b,), dtype=torch.bool)
    loss_vit = zero
    if cfg.vit_weight > 0:
        with span("step.vit"):
            # per item: refresh on a coin of p = VIT_REFRESH_PROB, or while the
            # cache is invalid (the first step); the coins are host tensors, so
            # whether to run the ViT on the real patch reads nothing back
            refresh = step2_draws.refresh if step2_draws.refresh is not None else refresh_coins(b)
            refresh = refresh.cpu() | ~ref_feature_valid.cpu()
            if bool(refresh.any()):
                with torch.no_grad(), span("step.vit.refresh"):
                    fresh = vit_cls(vit, real_patch)
                # a non-blocking copy of the host coins: a blocking one would
                # wait for the render queued before it
                mask = refresh.to(real_patch.device, non_blocking=True)
                ref_feature = torch.where(mask[:, None], fresh, ref_feature)
            ref_feature_valid = ref_feature_valid.cpu() | refresh
            # one batched ViT call for both rendered patches
            sem = vit_cls(vit, torch.cat([side_imgs["rgb_coarse"], side_imgs["rgb_fine"]], dim=0))
            loss_vit = torch.mean((sem[:b] - ref_feature) ** 2) + torch.mean((sem[b:] - ref_feature) ** 2)

    # ---- patch depth supervision (sinnerf.py:354-387) ---------------------
    depth_gt_img = batch["depth_gt"].reshape(b, psx, psy)
    full_depth_fine = results_full["depth_fine"].reshape(b, psx, psy)
    full_depth_coarse = results_full["depth_coarse"].reshape(b, psx, psy)
    depth_patch_metrics = {}
    if cfg.is_dtu:
        for d in (full_depth_fine, full_depth_coarse):
            loss_depth = loss_depth + smooth_l1_masked_per_item(d.reshape(b, -1), depth_gt_img.reshape(b, -1))
    else:
        dpatch = depth_patch_loss_fn(
            {"rgb_fine": full_depth_fine[:, None], "rgb_coarse": full_depth_coarse[:, None]},
            depth_gt_img[:, None],
        )
        loss_depth = loss_depth + dpatch["tot"]
        depth_patch_metrics["train/depth_l2"] = dpatch["l2"]
        if "ssim" in dpatch:
            depth_patch_metrics["train/depth_ssim"] = dpatch["ssim"]

    loss_depth_smooth = inverse_depth_smoothness_loss(
        full_depth_fine[:, None], full_imgs["rgb_fine"]
    ) + inverse_depth_smoothness_loss(full_depth_coarse[:, None], full_imgs["rgb_fine"])

    if cfg.is_blender:
        need_zero = depth_gt_img.reshape(b, -1) == 0
        for d in (full_depth_coarse, full_depth_fine):
            loss_depth = loss_depth + 2.0 * smooth_l1_masked_per_item(
                d.reshape(b, -1), depth_gt_img.reshape(b, -1), mask=need_zero
            )

    # ---- pseudo-view depth losses (sinnerf.py:389-406) --------------------
    side_depth_fine = results_side["depth_fine"].reshape(b, psx, psy)
    side_depth_coarse = results_side["depth_coarse"].reshape(b, psx, psy)
    loss_depth_smooth = (
        loss_depth_smooth
        + inverse_depth_smoothness_loss(side_depth_coarse[:, None], side_imgs["rgb_fine"])
        + inverse_depth_smoothness_loss(side_depth_fine[:, None], side_imgs["rgb_fine"])
    )
    warp_depth = batch["warp_patch_depth"].reshape(b, psx, psy)
    depth_mask = warp_depth > 0
    loss_side_depth = smooth_l1_masked_per_item(
        side_depth_coarse, warp_depth, mask=depth_mask
    ) + smooth_l1_masked_per_item(side_depth_fine, warp_depth, mask=depth_mask)

    # ---- adversarial losses (sinnerf.py:445-487) --------------------------
    loss_d_g = loss_d_d = zero
    d_u = None
    if cfg.dis_weight > 0:
        with span("step.disc"):
            fake_img = side_imgs["rgb_fine"]
            sd = step2_draws

            def d_call(x, u, frozen, d_draws):
                return discriminator(x, u, frozen=frozen, draws=d_draws, generator=generator, policy=POLICY)

            # G term: frozen D, its u advanced by this call first
            pred_fake_g, u = d_call(fake_img, None, True, sd.d_fake_g)
            g_pred_real = None
            if cfg.dloss == "relavistic":
                # the reference's G branch runs its own D(DiffAugment(real))
                # (sinnerf.py:454): an outer augmentation with its own coin,
                # then D's internal one
                apply = sd.real_g_coin if sd.real_g_coin is not None else coin(real_patch, generator)
                x_real_g = torch.where(apply, diff_augment(real_patch, POLICY, sd.real_g_aug, generator), real_patch)
                g_pred_real, u = d_call(x_real_g, u, True, sd.d_real_g)
            # D terms: live D, detached renders
            if cfg.dloss == "wgan_gp":
                # R1 through the very pred_real forward, second order
                # (create_graph), as the JAX step differentiates it
                x_real = real_patch.detach().requires_grad_(True)
                pred_real, u = d_call(x_real, u, False, sd.d_real)
                (grads_x,) = torch.autograd.grad(pred_real.sum(), x_real, create_graph=True)
            else:
                pred_real, u = d_call(real_patch, u, False, sd.d_real)
            pred_fake_d, d_u = d_call(fake_img.detach(), u, False, sd.d_fake)
            g_real = g_pred_real if g_pred_real is not None else pred_real
            loss_d_g = gan_g_loss(pred_fake_g, cfg.dloss, pred_real=g_real.detach())
            loss_d_d = gan_d_loss(pred_real, pred_fake_d, cfg.dloss)
            if cfg.dloss == "wgan_gp":
                loss_d_d = loss_d_d + 10.0 * torch.mean(torch.sum(grads_x.reshape(b, -1) ** 2, dim=1))

    # ---- total (sinnerf.py:492-509) ---------------------------------------
    dw = max(cfg.depth_weight - epoch / (500.0 / cfg.depth_weight), 1.0) if cfg.depth_anneal else cfg.depth_weight
    total = (
        loss_g["tot"]
        + cfg.dis_weight * (loss_d_g + loss_d_d)
        + dw * loss_depth
        + cfg.proj_weight * cfg.depth_weight * loss_side_depth
        + cfg.vit_weight * loss_vit
        + cfg.depth_smooth_weight * loss_depth_smooth
    )

    metrics = {
        "train/loss": total,
        "train/loss_g": loss_g["tot"],
        "train/loss_vit": loss_vit,
        "train/loss_d": loss_d_d,
        "train/loss_g_adv": loss_d_g,
        "train/loss_depth": loss_depth,
        "train/loss_depth_smooth": loss_depth_smooth,
        "train/loss_side_depth": loss_side_depth,
        "train/psnr": psnr(results["rgb_fine"], rgbs),
        "train/depth_min": torch.min(results_full["depth_fine"]),
        "train/depth_max": torch.max(results_full["depth_fine"]),
        **depth_patch_metrics,
    }
    if "ssim" in loss_g:  # sinnerf.py:379-381
        metrics["train/ssim"] = loss_g["ssim"]

    # white-filled warp patch for the side image stack (sinnerf.py:303-305)
    warp_mask = torch.sum(batch["warp_patch"], dim=1, keepdim=True) > 0
    side_rgb = torch.where(warp_mask, batch["warp_patch"], torch.ones_like(batch["warp_patch"]))
    images = {
        "real_patch": real_patch,
        "rgb_coarse_full": full_imgs["rgb_coarse"],
        "rgb_fine_full": full_imgs["rgb_fine"],
        "side_rgb": side_rgb,
        "rgb_coarse_side": side_imgs["rgb_coarse"],
        "rgb_fine_side": side_imgs["rgb_fine"],
        "depth_coarse_side": side_depth_coarse,
        "depth_fine_side": side_depth_fine,
        "warp_depth": warp_depth,
    }
    aux = {
        "metrics": {k: v.detach() for k, v in metrics.items()},
        "images": {k: v.detach() for k, v in images.items()},
        "d_u": d_u,
        "ref_feature": ref_feature.detach(),
        "ref_feature_valid": ref_feature_valid,
    }
    return total, aux


def train_step(
    state: TrainState,
    batch: Dict[str, torch.Tensor],
    cfg: TrainConfig,
    epoch: float = 0.0,
    draws: RenderDraws = RenderDraws(),
    generator: Optional[torch.Generator] = None,
    step2_draws: Step2Draws = Step2Draws(),
    grad_hook: Optional[Callable[[Sequence[torch.optim.Optimizer]], None]] = None,
) -> Tuple[TrainState, Dict[str, Any]]:
    """One optimization step: renders once, backpropagates the total loss
    once and steps ``opt_g`` and, with the GAN on, ``opt_d``, in place; the
    discriminator's ``u`` and the ViT cache advance.  Returns the state and
    ``{'metrics', 'images'}``; the parameters' ``.grad`` hold this step's
    gradients.  ``grad_hook``, when given, is called with the optimizers
    that step (``opt_g``, and ``opt_d`` with the GAN on) after ``backward``
    has written every ``.grad`` and before either steps: data parallelism
    all-reduces the gradients there (``parallel.ddp.gradient_hook``).  The
    metrics stay this batch's."""
    gan = cfg.dis_weight > 0
    with span("step"):
        state.opt_g.zero_grad(set_to_none=True)
        if gan:
            state.opt_d.zero_grad(set_to_none=True)
        with span("step.losses"):
            total, aux = compute_losses(
                state.models, batch, cfg, epoch, draws, generator, discriminator=state.discriminator,
                vit=state.vit, vgg=state.vgg, ref_feature=state.ref_feature,
                ref_feature_valid=state.ref_feature_valid, step2_draws=step2_draws,
            )
        with span("step.backward"):
            total.backward()
        with span("step.optimizer"):
            if grad_hook is not None:
                grad_hook([state.opt_g, state.opt_d] if gan else [state.opt_g])
            state.opt_g.step()
            if gan:
                state.opt_d.step()
                state.discriminator.set_u(aux["d_u"])
            if cfg.vit_weight > 0:
                state.ref_feature, state.ref_feature_valid = aux["ref_feature"], aux["ref_feature_valid"]
        state.step += 1
    return state, {"metrics": aux["metrics"], "images": aux["images"]}
