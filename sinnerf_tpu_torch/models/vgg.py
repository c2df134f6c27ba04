"""VGG16 feature trunk through relu4_3, for the ``l2_vgg`` patch loss.

Counterpart of ``sinnerf_tpu/models/vgg.py`` (reference ``losses.py:112-132``,
``VGG16LossDirect``): torchvision's ``vgg16().features[:23]``, convolution
blocks 64-64 / 128-128 / 256-256-256 / 512-512-512 with max pools, stopping
after relu4_3.  The layers sit at torchvision's indices, so its state dict
(``features.<i>.weight``, or the ``features`` sub-dict's ``<i>.weight``)
loads by key.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from sinnerf_tpu_torch.models.vit import frozen, imagenet_normalize, read_state, torch_nearest_resize

# out channels per convolution, "M" = 2x2 max pool: vgg16.features[:23]
CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512]
CONV_INDICES = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21]  # torchvision's indices of the 10 convolutions


class VGG16Features(nn.Module):
    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        layers: List[nn.Module] = []
        cin = 3
        for c in CFG:
            if c == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, c, 3, padding=1), nn.ReLU()]
                cin = c
        self.features = nn.Sequential(*layers)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Random weights uniform in +-1/sqrt(fan_in), as JAX
        ``init_vgg_params`` draws them (from another generator)."""
        for m in self.features:
            if isinstance(m, nn.Conv2d):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                for t in (m.weight, m.bias):
                    t.copy_((torch.rand(t.shape, generator=generator) * 2.0 - 1.0) * bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, 224, 224) normalised -> relu4_3 maps (B, 512, 28, 28)."""
        return self.features(x)


def vgg_preprocess(x: torch.Tensor) -> torch.Tensor:
    """Nearest resize of (B, 3, H, W) to 224 and ImageNet normalisation
    (losses.py:124-131)."""
    if x.dim() != 4:
        raise ValueError(f"the VGG loss needs (B, 3, H, W) images, got shape {tuple(x.shape)} "
                         "(as in the reference, it cannot take ray bundles)")
    return imagenet_normalize(torch_nearest_resize(x, 224))


def import_torch_vgg_state(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """torchvision ``vgg16().state_dict()`` (or its ``features`` sub-dict)
    -> this trunk's state dict (JAX ``import_torch_vgg_state`` :93-114)."""
    out = {}
    for i in CONV_INDICES:
        for prefix in (f"features.{i}.", f"{i}."):
            if prefix + "weight" in state_dict:
                for name in ("weight", "bias"):
                    out[f"features.{i}.{name}"] = torch.as_tensor(state_dict[prefix + name], dtype=torch.float32)
                break
        else:
            raise KeyError(f"conv {i} not found in the VGG state dict")
    return out


def vgg_state_from_jax(params) -> Dict[str, torch.Tensor]:
    """The JAX package's VGG params (a list of ``{'w', 'b'}``) as this
    trunk's state dict."""
    return {f"features.{i}.{name}": torch.tensor(np.array(layer[key], np.float32))
            for i, layer in zip(CONV_INDICES, params) for name, key in (("weight", "w"), ("bias", "b"))}


def load_vgg(path: Optional[str] = None, generator: Optional[torch.Generator] = None) -> VGG16Features:
    """A frozen trunk: torchvision VGG16 weights from a local file, or random
    weights from ``generator`` when ``path`` is None."""
    model = VGG16Features(generator)
    if path is not None:
        model.load_state_dict(import_torch_vgg_state(read_state(path)))
    return frozen(model)
