"""The inputs the benchmark makes from ``--seed`` and hands to both sides:
the models' weights and the random draws of the steps it checks.

Weights are drawn on the device by one ``torch.Generator`` in two calls per
model (one of uniforms, one of normals), then split into the leaves of the
reference's module, whose state-dict names and shapes the port's modules
share.  Each leaf follows the init the port's own random init uses: linear
layers and convolutions uniform in +-1/sqrt(fan_in), the ViT's patch
embedding, CLS token and positions normal x 0.02, norms 1 and 0, the
discriminator's power-iteration vectors standard normal.  The NeRFs' sigma
head's bias is then raised by ``SIGMA_SHIFT``, so that the field is opaque
and absorbs every ray before its last sample, as a trained field does.  A
field that lets rays reach the last sample (whose interval is 1e10 long)
makes that sample's alpha a step function of a sigma near 0, and a
rounding then flips a whole ray; a random field that is empty everywhere
renders zeros and checks nothing.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from benchmark.reference.diffaug import DiffAugDraws, fill_draws
from benchmark.reference.discriminator import DCallDraws, Discriminator, SNConv
from benchmark.reference.nerf import NeRF
from benchmark.reference.step import POLICY
from benchmark.reference.vit import ViT

SIGMA_SHIFT = 3.0  # chip_smoke.py's TRAIN_SIGMA_SHIFT

# (leaf name, kind, scale): kind "uniform" draws U(-scale, scale), "normal"
# N(0, scale^2), "const" fills with scale
Rule = Tuple[str, str, float]


def _rules(module: nn.Module) -> List[Rule]:
    rules: List[Rule] = []
    for prefix, m in module.named_modules():
        p = f"{prefix}." if prefix else ""
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            rules += [(p + "weight", "uniform", bound), (p + "bias", "uniform", bound)]
        elif isinstance(m, nn.LayerNorm):
            rules += [(p + "weight", "const", 1.0), (p + "bias", "const", 0.0)]
        elif isinstance(m, nn.Conv2d):  # the ViT's patch embedding
            rules += [(p + "weight", "normal", 0.02), (p + "bias", "const", 0.0)]
        elif isinstance(m, SNConv):
            bound = 1.0 / math.sqrt(m.weight_orig[0].numel())
            rules += [(p + "weight_orig", "uniform", bound), (p + "weight_u", "normal", 1.0)]
    if isinstance(module, ViT):
        rules += [("cls_token", "normal", 0.02), ("pos_embed", "normal", 0.02)]
    return rules


def draw_state(module: nn.Module, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Every leaf of ``module``'s state dict, drawn on ``generator``'s
    device in one call per distribution."""
    shapes = {k: v.shape for k, v in module.state_dict().items()}
    rules = _rules(module)
    missing = set(shapes) - {name for name, _, _ in rules}
    if missing:
        raise ValueError(f"no draw rule for {sorted(missing)}")
    dev = generator.device
    sizes = {kind: sum(math.prod(shapes[n]) for n, k, _ in rules if k == kind) for kind in ("uniform", "normal")}
    pools = {"uniform": torch.rand(sizes["uniform"], generator=generator, device=dev) * 2.0 - 1.0,
             "normal": torch.randn(sizes["normal"], generator=generator, device=dev)}
    offsets = {"uniform": 0, "normal": 0}
    out = {}
    for name, kind, scale in rules:
        shape = shapes[name]
        if kind == "const":
            out[name] = torch.full(shape, scale, device=dev)
            continue
        n = math.prod(shape)
        out[name] = (pools[kind][offsets[kind]: offsets[kind] + n] * scale).reshape(shape)
        offsets[kind] += n
    return out


def weights(generator: torch.Generator, vit: bool, disc_imsize: Optional[int]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The run's weights: ``coarse``, ``fine`` and, when the cell uses them,
    ``vit`` and ``discriminator`` (at ``disc_imsize``)."""
    with torch.device("meta"):
        shapes = {"coarse": NeRF(), "fine": NeRF()}
        if vit:
            shapes["vit"] = ViT()
    if disc_imsize is not None:
        shapes["discriminator"] = Discriminator(imsize=disc_imsize, generator=torch.Generator())
    out = {k: draw_state(m, generator) for k, m in shapes.items()}
    for level in ("coarse", "fine"):
        out[level]["sigma.bias"] += SIGMA_SHIFT
    return out


def render_draws(n_rays: int, n_samples: int, n_importance: int, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A stochastic render's draws over ``n_rays`` rays: the stratified
    jitter, the coarse and fine sigma noise and the importance uniforms."""
    dev = generator.device
    return {
        "perturb_u": torch.rand((n_rays, n_samples), generator=generator, device=dev),
        "noise_coarse": torch.randn((n_rays, n_samples), generator=generator, device=dev),
        "pdf_u": torch.rand((n_rays, n_importance), generator=generator, device=dev),
        "noise_fine": torch.randn((n_rays, n_samples + n_importance), generator=generator, device=dev),
    }


def d_call_draws(patch: torch.Tensor, generator: torch.Generator) -> DCallDraws:
    """One discriminator call's draws on patches like ``patch`` (B, 3, H,
    W): the coin that applies DiffAugment and DiffAugment's own."""
    like = patch.detach().to(generator.device)
    c = torch.rand((), generator=generator, device=generator.device) < 0.5
    return DCallDraws(coin=c, aug=fill_draws(like, POLICY, DiffAugDraws(), generator))


def refresh_coins(b: int, generator: torch.Generator, p: float = 0.05) -> torch.Tensor:
    """(b,) bool host coins: refresh the item's cached ViT feature."""
    return (torch.rand((b,), generator=generator, device=generator.device) < p).cpu()
