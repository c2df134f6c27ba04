"""One training step on plain PyTorch: the reference for the port's
``train_step``.

The losses of ``sinnerf_tpu_torch/train/step.py::compute_losses`` (reference
``models/sinnerf.py:271-554``) for the recipes the benchmark runs: the MSE
ray and patch losses, the depth losses, the DINO-ViT CLS loss on the
pseudo-view patch against a per-item cached feature, and the PatchGAN's
hinge terms with DiffAugment inside D.  One ``backward`` gives the G and D
gradients, then Adam (``adam_step``) updates each.  Every draw is passed in;
the batch has the sampler's key schema:

    rays (B, N, 8) | rgbs (B, N, 3) | depth (B, N, 1)   random ref-view rays
    rays_proj (B, N, 8) | depth_proj (B, N, 1)          warped pseudo-view rays
    real_patch (B, 3, px, py)                           ref-image patch
    rays_full (B, px*py, 8)                             pseudo-view patch rays
    warp_patch (B, 3, px, py) | warp_patch_depth (B, px, py)
    depth_ray (B, px*py, 8) | depth_gt (B, px*py, 1) | depth_ray_rgb (B, px*py, 3)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from benchmark.reference import gan
from benchmark.reference.depth import inverse_depth_smoothness_loss, smooth_l1_masked, smooth_l1_masked_per_item
from benchmark.reference.photometric import mse_loss
from benchmark.reference.render import Settings, render_rays
from benchmark.reference.vit import vit_cls

POLICY = "color,cutout"


@dataclasses.dataclass(frozen=True)
class StepConfig:
    render: Settings
    blender: bool = False
    dtu: bool = False
    dloss: str = "hinge"
    depth_weight: float = 8.0
    vit_weight: float = 0.0
    dis_weight: float = 0.0
    proj_weight: float = 1.0
    depth_smooth_weight: float = 0.0


def _flat(x: torch.Tensor, c: int) -> torch.Tensor:
    return x.reshape(-1, c)


def _imgify(flat: torch.Tensor, b: int, c: int, p: int, q: int) -> torch.Tensor:
    return flat.reshape(b, p, q, c).permute(0, 3, 1, 2)


def losses(models, batch, cfg: StepConfig, draws: Dict[str, Optional[torch.Tensor]], *, vit=None,
           discriminator=None, ref_feature=None, refresh=None, d_draws=None):
    """(total loss, the new ViT feature cache, D's new ``u``) of one batch.
    ``draws``: ``perturb_u``, ``noise_coarse``, ``pdf_u``, ``noise_fine``
    over the four bundles' rays in order; ``refresh`` (B,) bool: refresh
    the item's cached ViT feature; ``d_draws``: the ``DCallDraws`` of D's
    three calls (G's term on the fake patch, D's on the real and on the
    detached fake patch)."""
    b = batch["rays"].shape[0]
    psx, psy = batch["real_patch"].shape[-2:]
    bundles = [_flat(batch[k], 8) for k in ("rays", "depth_ray", "rays_full", "rays_proj")]
    rendered = render_rays(models, torch.cat(bundles), cfg.render, draws["perturb_u"], draws["noise_coarse"],
                           draws["pdf_u"], draws["noise_fine"])
    offs = [0]
    for r in bundles:
        offs.append(offs[-1] + r.shape[0])
    res, res_full, res_side, res_proj = ({k: v[offs[i]: offs[i + 1]] for k, v in rendered.items()}
                                         for i in range(4))
    rgbs = _flat(batch["rgbs"], 3)
    depth = _flat(batch["depth"], 1)[:, 0]
    depth_proj = _flat(batch["depth_proj"], 1)[:, 0]
    rgbs_full_img = _imgify(_flat(batch["depth_ray_rgb"], 3), b, 3, psx, psy)
    real_patch = batch["real_patch"]

    loss_depth = (smooth_l1_masked(res_proj["depth_fine"], depth_proj, use_mask=False)
                  + smooth_l1_masked(res_proj["depth_coarse"], depth_proj, use_mask=False)
                  + smooth_l1_masked(res["depth_fine"], depth, use_mask=False)
                  + smooth_l1_masked(res["depth_coarse"], depth, use_mask=False))
    loss_g = mse_loss(res, rgbs)["tot"]
    full = {k: _imgify(res_full[k], b, 3, psx, psy) for k in ("rgb_coarse", "rgb_fine")}
    side = {k: _imgify(res_side[k], b, 3, psx, psy) for k in ("rgb_coarse", "rgb_fine")}
    loss_g = loss_g + mse_loss(full, rgbs_full_img)["tot"]

    zero = torch.zeros((), device=real_patch.device)
    loss_vit = zero
    if cfg.vit_weight > 0:
        with torch.no_grad():
            fresh = vit_cls(vit, real_patch)
        ref_feature = torch.where(refresh.to(real_patch.device)[:, None], fresh, ref_feature)
        sem = vit_cls(vit, torch.cat([side["rgb_coarse"], side["rgb_fine"]], dim=0))
        loss_vit = torch.mean((sem[:b] - ref_feature) ** 2) + torch.mean((sem[b:] - ref_feature) ** 2)

    depth_gt = batch["depth_gt"].reshape(b, psx, psy)
    full_fine = res_full["depth_fine"].reshape(b, psx, psy)
    full_coarse = res_full["depth_coarse"].reshape(b, psx, psy)
    if cfg.dtu:
        for d in (full_fine, full_coarse):
            loss_depth = loss_depth + smooth_l1_masked_per_item(d.reshape(b, -1), depth_gt.reshape(b, -1))
    else:
        loss_depth = loss_depth + mse_loss({"rgb_fine": full_fine[:, None], "rgb_coarse": full_coarse[:, None]},
                                           depth_gt[:, None])["tot"]
    loss_smooth = (inverse_depth_smoothness_loss(full_fine[:, None], full["rgb_fine"])
                   + inverse_depth_smoothness_loss(full_coarse[:, None], full["rgb_fine"]))
    if cfg.blender:
        need_zero = depth_gt.reshape(b, -1) == 0
        for d in (full_coarse, full_fine):
            loss_depth = loss_depth + 2.0 * smooth_l1_masked_per_item(d.reshape(b, -1), depth_gt.reshape(b, -1),
                                                                      mask=need_zero)
    side_fine = res_side["depth_fine"].reshape(b, psx, psy)
    side_coarse = res_side["depth_coarse"].reshape(b, psx, psy)
    loss_smooth = (loss_smooth + inverse_depth_smoothness_loss(side_coarse[:, None], side["rgb_fine"])
                   + inverse_depth_smoothness_loss(side_fine[:, None], side["rgb_fine"]))
    warp_depth = batch["warp_patch_depth"].reshape(b, psx, psy)
    mask = warp_depth > 0
    loss_side = (smooth_l1_masked_per_item(side_coarse, warp_depth, mask=mask)
                 + smooth_l1_masked_per_item(side_fine, warp_depth, mask=mask))

    loss_adv_g = loss_adv_d = zero
    d_u = None
    if cfg.dis_weight > 0:
        if cfg.dloss != "hinge":
            raise NotImplementedError("the reference step holds the hinge GAN loss only")
        fake = side["rgb_fine"]
        pred_fake_g, u = discriminator(fake, None, frozen=True, draws=d_draws[0], policy=POLICY)
        pred_real, u = discriminator(real_patch, u, frozen=False, draws=d_draws[1], policy=POLICY)
        pred_fake_d, d_u = discriminator(fake.detach(), u, frozen=False, draws=d_draws[2], policy=POLICY)
        loss_adv_g = gan.g_loss(pred_fake_g, "hinge")
        loss_adv_d = gan.d_loss(pred_real, pred_fake_d, "hinge")

    total = (loss_g + cfg.dis_weight * (loss_adv_g + loss_adv_d) + cfg.depth_weight * loss_depth
             + cfg.proj_weight * cfg.depth_weight * loss_side + cfg.vit_weight * loss_vit
             + cfg.depth_smooth_weight * loss_smooth)
    return total, (None if ref_feature is None else ref_feature.detach()), d_u


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8, no weight decay), the recipes'
    ``--optimizer adam``: per parameter the moments ``m``, ``v`` and
    ``p -= lr * m^ / (sqrt(v^) + eps)`` with the bias-corrected ``m^``,
    ``v^``."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params: List[torch.Tensor] = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            if p.grad is None:
                continue
            m.mul_(self.b1).add_(p.grad, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(p.grad, p.grad, value=1.0 - self.b2)
            p.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + self.eps))

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None
