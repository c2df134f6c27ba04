"""The NeRF MLP as an ``nn.Module`` in the reference's key layout.

Counterpart of ``sinnerf_tpu/models/nerf.py`` (reference
``models/nerf.py:46-148``): an 8x256 xyz trunk with the skip concat before
layer index 4 (``xyz_encoding_5``), a sigma head, a 256-wide bottleneck
(``xyz_encoding_final``) feeding a 128-wide direction branch, and the rgb
head.  ``state_dict`` keys are the reference's (``xyz_encoding_1.0.weight``
... ``dir_encoding.0.weight``, ``rgb.0.weight``), so reference checkpoints
load unchanged.

``precision`` rounds every dense layer's input and weight before a float32
product (``round_to``): None keeps float32, ``"bfloat16"`` rounds to bf16,
``"tf32"`` to TF32's 10-bit mantissa and ``"fp8"`` to float8 e4m3 with one
scale per tensor.  The last two are the benchmark's controls: the
configuration's precision one step lower.  Matmuls run with TF32 off
(``render.plain_matmuls``), so float32 is float32 on any device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from benchmark.reference.activations import shifted_softplus, widened_sigmoid

DEFAULT_D = 8
DEFAULT_W = 256
IN_XYZ = 63
IN_DIR = 27


FP8_MAX = 448.0  # the largest finite float8 e4m3 value
PRECISIONS = (None, "bfloat16", "tf32", "fp8")


def round_to(x: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    """``x`` (float32) rounded to ``precision`` and back to float32; the
    rounding passes gradients straight through."""
    x = x.float()
    if precision is None:
        return x
    if precision == "bfloat16":
        return x.to(torch.bfloat16).float()
    if precision == "tf32":
        # round to nearest (ties away) at 10 mantissa bits, as the tensor cores
        # round their float32 inputs
        bits = x.detach().view(torch.int32)
        rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        return x + (rounded - x.detach())
    if precision == "fp8":
        scale = torch.clamp(x.detach().abs().amax(), min=1e-30) / FP8_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (q - x.detach())
    raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def dense(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    precision: Optional[str],
) -> torch.Tensor:
    """``x @ weight.T + bias`` with inputs rounded to ``precision`` and a
    float32 sum; the bias is added after the product, as JAX does."""
    y = round_to(x, precision) @ round_to(weight, precision).T
    return y if bias is None else y + bias.float()


class NeRF(nn.Module):
    def __init__(
        self,
        depth: int = DEFAULT_D,
        width: int = DEFAULT_W,
        in_channels_xyz: int = IN_XYZ,
        in_channels_dir: int = IN_DIR,
        skips: Tuple[int, ...] = (4,),
        use_new_activation: bool = True,
    ):
        super().__init__()
        self.depth = depth
        self.width = width
        self.in_channels_xyz = in_channels_xyz
        self.in_channels_dir = in_channels_dir
        self.skips = tuple(skips)
        self.use_new_activation = use_new_activation
        for i in range(depth):
            fan_in = in_channels_xyz if i == 0 else width
            if i in skips:
                fan_in = width + in_channels_xyz
            # one-element Sequentials keep the reference's ``.0.`` keys; the
            # activations are applied in forward, after the dtype handling
            setattr(self, f"xyz_encoding_{i + 1}", nn.Sequential(nn.Linear(fan_in, width)))
        self.xyz_encoding_final = nn.Linear(width, width)
        self.sigma = nn.Linear(width, 1)
        self.dir_encoding = nn.Sequential(nn.Linear(width + in_channels_dir, width // 2))
        self.rgb = nn.Sequential(nn.Linear(width // 2, 3))

    def linear(self, key: str) -> nn.Linear:
        """The ``nn.Linear`` of a JAX param key (``"xyz_encoding_5"``, ...)."""
        mod = getattr(self, key)
        return mod[0] if isinstance(mod, nn.Sequential) else mod

    def forward(
        self,
        xyz_embedded: torch.Tensor,
        dir_embedded: Optional[torch.Tensor] = None,
        sigma_only: bool = False,
        precision: Optional[str] = None,
    ) -> torch.Tensor:
        """xyz_embedded (..., 63), dir_embedded (..., 27) in the reference PE
        order -> (..., 4) ``[rgb, sigma]``, or (..., 1) sigma when
        ``sigma_only`` (JAX ``nerf_apply``)."""

        def lin(key, x):
            layer = self.linear(key)
            return dense(x, layer.weight, layer.bias, precision)

        x = xyz_embedded
        for i in range(self.depth):
            if i in self.skips:
                x = torch.cat([xyz_embedded, x], dim=-1)
            x = torch.relu(lin(f"xyz_encoding_{i + 1}", x))
        sigma = lin("sigma", x)
        if sigma_only:
            return sigma
        feat = lin("xyz_encoding_final", x)
        d = lin("dir_encoding", torch.cat([feat, dir_embedded.float()], dim=-1))
        d = shifted_softplus(d) if self.use_new_activation else torch.relu(d)
        rgb = lin("rgb", d)
        rgb = widened_sigmoid(rgb) if self.use_new_activation else torch.sigmoid(rgb)
        return torch.cat([rgb, sigma], dim=-1)
