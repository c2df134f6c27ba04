"""One training step of the Step-1 recipe: render, losses, backward, update.

Counterpart of ``sinnerf_tpu/train/step.py`` (reference
``SinNeRF.training_step``, ``models/sinnerf.py:271-554``).  The four ray
bundles of a batch (random rays, reference-view patch, pseudo-view patch,
projected rays) are concatenated and rendered in one pass; the depth,
photometric, smoothness and pseudo-view depth losses are summed with the
reference's weights (``sinnerf.py:492-509``):

    total = loss_g.tot + depth_weight * loss_depth
          + proj_weight * depth_weight * loss_side_depth
          + depth_smooth_weight * loss_depth_smooth

Masked depth losses are per item and then averaged over the batch axis, as
in the JAX package.  The ViT semantic loss, the PatchGAN terms and the
``l2_vgg`` patch loss are the Step-2 extras of a later slice; asking for
them raises.  Metric tags and the ``images`` entries are the JAX package's.

Every random draw of the render can be passed in (``RenderDraws``); a draw
not passed comes from the ``torch.Generator`` given.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from sinnerf_tpu_torch.losses.depth import (
    inverse_depth_smoothness_loss,
    smooth_l1_masked,
    smooth_l1_masked_per_item,
)
from sinnerf_tpu_torch.losses.photometric import L2_VGG_LOSS, loss_dict
from sinnerf_tpu_torch.models.nerf import NeRF
from sinnerf_tpu_torch.render.renderer import RenderSettings, render_rays
from sinnerf_tpu_torch.utils.metrics import psnr


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Per-run configuration; fields map 1:1 onto the ``opt.py`` flags, as
    the JAX ``TrainConfig`` does.  The fields that only the Step-2 extras
    read (``dloss``, ``imsize``, ``policy``, ``vit_refresh_prob``) come with
    them."""

    render: RenderSettings
    dataset_name: str = "blender_ray_patch_1image_rot3d"
    loss_type: str = "mse"
    patch_loss: str = "mse"
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


class RenderDraws(NamedTuple):
    """The render's random draws over the N concatenated rays of a batch, as
    ``render_rays`` takes them."""

    perturb_u: Optional[torch.Tensor] = None     # (N, n_samples) uniforms
    noise_coarse: Optional[torch.Tensor] = None  # (N, n_samples) normals
    pdf_u: Optional[torch.Tensor] = None         # (N, n_importance) uniforms
    noise_fine: Optional[torch.Tensor] = None    # (N, n_samples + n_importance) normals


def _check_supported(cfg: TrainConfig) -> None:
    later = "is ported with the Step-2 extras (ViT, PatchGAN, VGG) in a later slice"
    if cfg.vit_weight > 0:
        raise NotImplementedError(f"vit_weight > 0: the DINO-ViT semantic loss {later}")
    if cfg.dis_weight > 0:
        raise NotImplementedError(f"dis_weight > 0: the PatchGAN discriminator {later}")
    if L2_VGG_LOSS in (cfg.patch_loss, cfg.loss_type):
        raise NotImplementedError(f"l2_vgg: the VGG16 perceptual loss {later}")
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
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(total scalar loss, aux with ``metrics`` and ``images``) of one batch
    with the sampler's schema."""
    _check_supported(cfg)
    b = batch["rays"].shape[0]
    psx, psy = batch["real_patch"].shape[-2:]
    loss_fn = loss_dict[cfg.loss_type]
    patch_loss_fn = loss_dict[cfg.patch_loss]

    # ---- one render over all 4 bundles ------------------------------------
    bundles = [_flat(batch[k], 8) for k in ("rays", "depth_ray", "rays_full", "rays_proj")]
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

    # ---- patch depth supervision (sinnerf.py:354-387) ---------------------
    depth_gt_img = batch["depth_gt"].reshape(b, psx, psy)
    full_depth_fine = results_full["depth_fine"].reshape(b, psx, psy)
    full_depth_coarse = results_full["depth_coarse"].reshape(b, psx, psy)
    depth_patch_metrics = {}
    if cfg.is_dtu:
        for d in (full_depth_fine, full_depth_coarse):
            loss_depth = loss_depth + smooth_l1_masked_per_item(d.reshape(b, -1), depth_gt_img.reshape(b, -1))
    else:
        dpatch = patch_loss_fn(
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

    # ---- total (sinnerf.py:492-509) ---------------------------------------
    dw = max(cfg.depth_weight - epoch / (500.0 / cfg.depth_weight), 1.0) if cfg.depth_anneal else cfg.depth_weight
    total = (
        loss_g["tot"]
        + dw * loss_depth
        + cfg.proj_weight * cfg.depth_weight * loss_side_depth
        + cfg.depth_smooth_weight * loss_depth_smooth
    )

    zero = torch.zeros((), dtype=total.dtype, device=total.device)
    metrics = {
        "train/loss": total,
        "train/loss_g": loss_g["tot"],
        "train/loss_vit": zero,
        "train/loss_d": zero,
        "train/loss_g_adv": zero,
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
    }
    return total, aux


def train_step(
    state: TrainState,
    batch: Dict[str, torch.Tensor],
    cfg: TrainConfig,
    epoch: float = 0.0,
    draws: RenderDraws = RenderDraws(),
    generator: Optional[torch.Generator] = None,
) -> Tuple[TrainState, Dict[str, Any]]:
    """One optimization step: renders once, backpropagates the total loss and
    updates the models in place.  Returns the state and ``{'metrics',
    'images'}``; the parameters' ``.grad`` hold this step's gradients."""
    state.opt_g.zero_grad(set_to_none=True)
    total, aux = compute_losses(state.models, batch, cfg, epoch, draws, generator)
    total.backward()
    state.opt_g.step()
    state.step += 1
    return state, aux
