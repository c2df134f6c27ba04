"""Differentiable GAN augmentations (DiffAugment) with explicit draws.

Counterpart of ``sinnerf_tpu/models/diffaug.py`` (reference
``models/diff_aug.py``): brightness, saturation, contrast, translation by up
to 1/8 of the side (zero-padded gather), cutout of half the side, and the
50% coin that passes the input through untouched (``diff_aug.py:14-15``).

Every draw can be passed in (``DiffAugDraws``); a draw not passed comes from
the ``torch.Generator`` given, on the generator's device.  The coins stay
tensors and select with ``torch.where``, as the JAX package's do, so no draw
is read back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

TRANSLATION_RATIO = 0.125
CUTOUT_RATIO = 0.5
SKIP_PROB = 0.5  # diff_aug.py:14


class DiffAugDraws(NamedTuple):
    """The draws of one ``diff_augment`` call on N images of H x W."""

    skip: Optional[torch.Tensor] = None        # () bool: return the input untouched
    brightness: Optional[torch.Tensor] = None  # (N, 1, 1, 1) uniforms in [0, 1)
    saturation: Optional[torch.Tensor] = None  # (N, 1, 1, 1) uniforms
    contrast: Optional[torch.Tensor] = None    # (N, 1, 1, 1) uniforms
    shift_h: Optional[torch.Tensor] = None     # (N, 1, 1) integers in [-sh, sh], sh = int(H / 8 + 0.5)
    shift_w: Optional[torch.Tensor] = None     # (N, 1, 1) integers in [-sw, sw]
    cutout_h: Optional[torch.Tensor] = None    # (N, 1, 1) integers in [0, H + 1 - (cut_h % 2))
    cutout_w: Optional[torch.Tensor] = None    # (N, 1, 1) integers in [0, W + 1 - (cut_w % 2))


def _device(generator: Optional[torch.Generator], like: torch.Tensor) -> torch.device:
    return generator.device if generator is not None else like.device


def _uniform(shape, like: torch.Tensor, generator) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=_device(generator, like), dtype=like.dtype).to(like.device)


def _randint(lo: int, hi: int, shape, like: torch.Tensor, generator) -> torch.Tensor:
    return torch.randint(lo, hi, shape, generator=generator, device=_device(generator, like)).to(like.device)


def coin(like: torch.Tensor, generator: Optional[torch.Generator] = None, p: float = 0.5) -> torch.Tensor:
    """A () bool tensor on ``like``'s device, true with probability ``p``."""
    return _uniform((), like, generator) < p


def _shift(side: int) -> int:
    return int(side * TRANSLATION_RATIO + 0.5)


def _cut(side: int) -> int:
    return int(side * CUTOUT_RATIO + 0.5)


def rand_brightness(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return x + (u - 0.5)


def rand_saturation(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    mean_c = torch.mean(x, dim=1, keepdim=True)
    return (x - mean_c) * (u * 2.0) + mean_c


def rand_contrast(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    mean_all = torch.mean(x, dim=(1, 2, 3), keepdim=True)
    return (x - mean_all) * (u + 0.5) + mean_all


def rand_translation(x: torch.Tensor, shift_h: torch.Tensor, shift_w: torch.Tensor) -> torch.Tensor:
    """Per-sample integer shift, zero-padded (diff_aug.py:47-64; JAX :32-48):
    output (i, j) reads the input at (i + shift_h, j + shift_w), or 0 outside."""
    n, _, h, w = x.shape
    src_h = torch.clamp(torch.arange(h, device=x.device)[None, :, None] + shift_h + 1, 0, h + 1)
    src_w = torch.clamp(torch.arange(w, device=x.device)[None, None, :] + shift_w + 1, 0, w + 1)
    x_pad = F.pad(x, (1, 1, 1, 1))
    batch = torch.arange(n, device=x.device)[:, None, None]
    return x_pad.permute(0, 2, 3, 1)[batch, src_h, src_w].permute(0, 3, 1, 2)


def rand_cutout(x: torch.Tensor, off_h: torch.Tensor, off_w: torch.Tensor) -> torch.Tensor:
    """Zero a box of half the side per sample, spanning [off - cut/2,
    off + cut/2) clamped into the image (diff_aug.py:67-86; JAX :51-72)."""
    _, _, h, w = x.shape
    cut_h, cut_w = _cut(h), _cut(w)
    grid_h = torch.arange(h, device=x.device)[None, :, None]
    grid_w = torch.arange(w, device=x.device)[None, None, :]
    lo_h = torch.clamp(off_h - cut_h // 2, 0, h - 1)
    hi_h = torch.clamp(off_h - cut_h // 2 + cut_h - 1, 0, h - 1)
    lo_w = torch.clamp(off_w - cut_w // 2, 0, w - 1)
    hi_w = torch.clamp(off_w - cut_w // 2 + cut_w - 1, 0, w - 1)
    inside = (grid_h >= lo_h) & (grid_h <= hi_h) & (grid_w >= lo_w) & (grid_w <= hi_w)
    return x * (1.0 - inside.to(x.dtype))[:, None]


def _policies(policy: str) -> Sequence[str]:
    names = [p for p in policy.split(",") if p]
    unknown = set(names) - {"color", "translation", "cutout"}
    if unknown:
        raise ValueError(f"unknown DiffAugment policy {sorted(unknown)}: use color, translation, cutout")
    return names


def fill_draws(
    x: torch.Tensor,
    policy: str,
    draws: DiffAugDraws = DiffAugDraws(),
    generator: Optional[torch.Generator] = None,
) -> DiffAugDraws:
    """``draws`` with every draw that ``diff_augment(x, policy)`` reads and
    that was not given drawn from ``generator``."""
    n, _, h, w = x.shape
    got = draws._asdict()

    def want(name, make):
        if got[name] is None:
            got[name] = make()

    want("skip", lambda: coin(x, generator, SKIP_PROB))
    for p in _policies(policy):
        if p == "color":
            for name in ("brightness", "saturation", "contrast"):
                want(name, lambda: _uniform((n, 1, 1, 1), x, generator))
        elif p == "translation":
            sh, sw = _shift(h), _shift(w)
            want("shift_h", lambda: _randint(-sh, sh + 1, (n, 1, 1), x, generator))
            want("shift_w", lambda: _randint(-sw, sw + 1, (n, 1, 1), x, generator))
        else:
            want("cutout_h", lambda: _randint(0, h + (1 - _cut(h) % 2), (n, 1, 1), x, generator))
            want("cutout_w", lambda: _randint(0, w + (1 - _cut(w) % 2), (n, 1, 1), x, generator))
    return DiffAugDraws(**got)


def diff_augment(
    x: torch.Tensor,
    policy: str = "color,cutout",
    draws: DiffAugDraws = DiffAugDraws(),
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Apply the policy to (N, C, H, W) images; with probability SKIP_PROB
    (the draw ``skip``) return ``x`` untouched."""
    if not policy:
        return x
    d = fill_draws(x, policy, draws, generator)
    out = x
    for p in _policies(policy):
        if p == "color":
            out = rand_contrast(rand_saturation(rand_brightness(out, d.brightness), d.saturation), d.contrast)
        elif p == "translation":
            out = rand_translation(out, d.shift_h, d.shift_w)
        else:
            out = rand_cutout(out, d.cutout_h, d.cutout_w)
    return torch.where(d.skip, x, out)
