"""DINO ViT-S/16, the frozen feature extractor of the semantic loss.

Counterpart of ``sinnerf_tpu/models/vit.py`` (reference
``models/extractor.py``, ``torch.hub`` ``dino_vits16``): patch 16, embed
384, 12 pre-norm blocks, 6 heads, MLP x4, qkv bias, LayerNorm eps 1e-6,
exact GELU.  The loss reads the final block's CLS token before the final
norm (``models/sinnerf.py:162-169``), after a nearest resize to 224 and
ImageNet normalisation.

The submodules carry DINO's state-dict names (``patch_embed.proj``,
``cls_token``, ``pos_embed``, ``blocks.<i>.norm1``, ``attn.qkv``,
``attn.proj``, ``norm2``, ``mlp.fc1``, ``mlp.fc2``, ``norm``), so a DINO
``.pth`` loads with ``load_state_dict``.  Attention is written as matmul +
softmax, as in the JAX package; the patch embedding is the same
non-overlapping reshape + matmul.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

EMBED_DIM = 384
DEPTH = 12
NUM_HEADS = 6
PATCH = 16
MLP_RATIO = 4
IMG_SIZE = 224
N_TOKENS = (IMG_SIZE // PATCH) ** 2 + 1  # 197
LN_EPS = 1e-6

# the port's own copy of the ImageNet statistics (sinnerf.py:162-167)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class PatchEmbed(nn.Module):
    def __init__(self):
        super().__init__()
        self.proj = nn.Conv2d(3, EMBED_DIM, PATCH, PATCH)


class Attention(nn.Module):
    def __init__(self):
        super().__init__()
        self.qkv = nn.Linear(EMBED_DIM, 3 * EMBED_DIM)
        self.proj = nn.Linear(EMBED_DIM, EMBED_DIM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Multi-head self-attention over (B, N, D) (JAX ``_attention``)."""
        b, n, d = x.shape
        head = d // NUM_HEADS
        qkv = self.qkv(x).reshape(b, n, 3, NUM_HEADS, head).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B, H, N, hd)
        attn = torch.softmax((q @ k.transpose(-2, -1)) / math.sqrt(head), dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, d))


class Mlp(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(EMBED_DIM, EMBED_DIM * MLP_RATIO)
        self.fc2 = nn.Linear(EMBED_DIM * MLP_RATIO, EMBED_DIM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class Block(nn.Module):
    def __init__(self):
        super().__init__()
        self.norm1 = nn.LayerNorm(EMBED_DIM, eps=LN_EPS)
        self.attn = Attention()
        self.norm2 = nn.LayerNorm(EMBED_DIM, eps=LN_EPS)
        self.mlp = Mlp()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """ViT-S/16 with DINO's parameter names.  ``norm`` (the final
    LayerNorm) is held so a DINO state dict loads whole; the features are
    read before it."""

    def __init__(self, depth: int = DEPTH, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.patch_embed = PatchEmbed()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, EMBED_DIM))
        self.pos_embed = nn.Parameter(torch.zeros(1, N_TOKENS, EMBED_DIM))
        self.blocks = nn.ModuleList(Block() for _ in range(depth))
        self.norm = nn.LayerNorm(EMBED_DIM, eps=LN_EPS)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Random weights as JAX ``init_vit_params`` draws them (from another
        generator): the patch embedding, CLS token and positions normal x
        0.02, linear layers uniform in +-1/sqrt(fan_in), norms 1 and 0."""
        def normal(t, std):
            t.copy_(torch.randn(t.shape, generator=generator) * std)

        def uniform(t, bound):
            t.copy_((torch.rand(t.shape, generator=generator) * 2.0 - 1.0) * bound)

        normal(self.patch_embed.proj.weight, 0.02)
        self.patch_embed.proj.bias.zero_()
        normal(self.cls_token, 0.02)
        normal(self.pos_embed, 0.02)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                uniform(m.weight, bound)
                uniform(m.bias, bound)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, 224, 224) -> (B, 197, D) tokens: the stride-16 patch
        convolution as a block reshape + matmul (JAX ``vit_tokens`` :95-128)."""
        b, c, hh, ww = x.shape
        gh, gw = hh // PATCH, ww // PATCH
        patches = (x.reshape(b, c, gh, PATCH, gw, PATCH).permute(0, 2, 4, 1, 3, 5)
                   .reshape(b, gh * gw, c * PATCH * PATCH))
        proj = self.patch_embed.proj
        tokens = patches @ proj.weight.reshape(EMBED_DIM, -1).t() + proj.bias
        cls = self.cls_token.expand(b, 1, EMBED_DIM)
        return torch.cat([cls, tokens], dim=1) + self.pos_embed


def torch_nearest_resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """``F.interpolate(mode='nearest')`` to size x size: source index
    ``floor(dst * (src / dst))`` in float32 (JAX ``torch_nearest_resize``
    :134-154), as a gather with those indices."""
    _, _, h, w = x.shape
    dst = torch.arange(size, dtype=torch.float32, device=x.device)
    rows = torch.floor(dst * torch.tensor(h / size, dtype=torch.float32)).long()
    cols = torch.floor(dst * torch.tensor(w / size, dtype=torch.float32)).long()
    return x[:, :, rows][:, :, :, cols]


@functools.lru_cache(maxsize=None)
def _imagenet_stats(device: torch.device, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The statistics as (1, 3, 1, 1) tensors, copied to a device once: a
    blocking copy per call would stop the host until the card had run all
    it was given, in the middle of a training step."""
    return tuple(torch.tensor(v, dtype=dtype).reshape(1, 3, 1, 1).to(device) for v in (IMAGENET_MEAN, IMAGENET_STD))


def imagenet_normalize(x: torch.Tensor) -> torch.Tensor:
    mean, std = _imagenet_stats(x.device, x.dtype)
    return (x - mean) / std


def vit_preprocess(x: torch.Tensor) -> torch.Tensor:
    """Nearest resize of (B, 3, H, W) to 224 and ImageNet normalisation
    (sinnerf.py:162-167; JAX ``vit_preprocess`` :156-164)."""
    return imagenet_normalize(torch_nearest_resize(x, IMG_SIZE))


def vit_cls(model: ViT, x: torch.Tensor) -> torch.Tensor:
    """Raw (B, 3, H, W) images in [0, 1] -> (B, 384), the final block's CLS
    token of each (the training loss's feature, sinnerf.py:169)."""
    h = model.embed(vit_preprocess(x))
    for block in model.blocks:
        h = block(h)
    return h[:, 0, :]


def frozen(model: nn.Module) -> nn.Module:
    """``model`` in eval mode with no parameter requiring a gradient."""
    for p in model.parameters():
        p.requires_grad_(False)
    return model.eval()
