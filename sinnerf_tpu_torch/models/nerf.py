"""The NeRF MLP as an ``nn.Module`` in the reference's key layout.

Counterpart of ``sinnerf_tpu/models/nerf.py`` (reference
``models/nerf.py:46-148``): an 8x256 xyz trunk with the skip concat before
layer index 4 (``xyz_encoding_5``), a sigma head, a 256-wide bottleneck
(``xyz_encoding_final``) feeding a 128-wide direction branch, and the rgb
head.  ``state_dict`` keys are the reference's (``xyz_encoding_1.0.weight``
... ``dir_encoding.0.weight``, ``rgb.0.weight``), so reference checkpoints
load unchanged.

``compute_dtype=torch.bfloat16`` rounds every dense layer's input and weight
to bf16 and accumulates in float32, like JAX's
``preferred_element_type=float32``: the products of two bf16 values are
exact in float32, so the matmul runs on the rounded values in float32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sinnerf_tpu_torch.core.activations import shifted_softplus, widened_sigmoid

DEFAULT_D = 8
DEFAULT_W = 256
IN_XYZ = 63
IN_DIR = 27

# JAX param key -> torch submodule prefix (JAX ``_TORCH_KEY_MAP``, nerf.py:235)
TORCH_KEY_MAP = {
    **{f"xyz_encoding_{i}": f"xyz_encoding_{i}.0" for i in range(1, 16)},
    "xyz_encoding_final": "xyz_encoding_final",
    "sigma": "sigma",
    "dir_encoding": "dir_encoding.0",
    "rgb": "rgb.0",
}


def dense(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    compute_dtype: Optional[torch.dtype],
) -> torch.Tensor:
    """``x @ weight.T + bias`` with inputs rounded to ``compute_dtype`` and a
    float32 sum; the bias is added after the product, as JAX does."""
    if compute_dtype is not None:
        x = x.to(compute_dtype).float()
        weight = weight.to(compute_dtype).float()
    y = x.float() @ weight.float().T
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
        compute_dtype: Optional[torch.dtype] = None,
    ) -> torch.Tensor:
        """xyz_embedded (..., 63), dir_embedded (..., 27) in the reference PE
        order -> (..., 4) ``[rgb, sigma]``, or (..., 1) sigma when
        ``sigma_only`` (JAX ``nerf_apply``)."""

        def lin(key, x):
            layer = self.linear(key)
            return dense(x, layer.weight, layer.bias, compute_dtype)

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


# --------------------------------------------------------------------------
# Weight carrier between the JAX param pytree and the port's state dict
# --------------------------------------------------------------------------


def state_dict_from_jax(params_np: Dict[str, Dict[str, Any]]) -> Dict[str, torch.Tensor]:
    """JAX params (``{'xyz_encoding_1': {'w': (in, out), 'b': (out,)}, ...}``
    as numpy) -> the port's state dict (weights transposed to (out, in))."""
    out = {}
    for key, torch_prefix in TORCH_KEY_MAP.items():
        if key not in params_np:
            continue
        w = np.asarray(params_np[key]["w"], dtype=np.float32)
        b = np.asarray(params_np[key]["b"], dtype=np.float32)
        out[f"{torch_prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(w.T))
        out[f"{torch_prefix}.bias"] = torch.from_numpy(b.copy())
    return out


def jax_from_state_dict(state: Dict[str, Any]) -> Dict[str, Dict[str, np.ndarray]]:
    """Inverse of ``state_dict_from_jax``: state dict -> JAX params as numpy.
    Raises ``KeyError`` when the state holds no NeRF weight."""
    params = {}
    for key, torch_prefix in TORCH_KEY_MAP.items():
        wk = f"{torch_prefix}.weight"
        if wk not in state:
            continue
        w = state[wk]
        b = state[f"{torch_prefix}.bias"]
        params[key] = {
            "w": np.ascontiguousarray(torch.as_tensor(w).detach().cpu().float().numpy().T),
            "b": torch.as_tensor(b).detach().cpu().float().numpy(),
        }
    if not params:
        raise KeyError("no NeRF weights found in the state dict")
    return params


def random_params(rng: np.random.Generator) -> Dict[str, Dict[str, np.ndarray]]:
    """Reference-width NeRF params as numpy in the JAX layout, drawn like
    torch's ``nn.Linear`` default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    shapes = {f"xyz_encoding_{i + 1}": (IN_XYZ if i == 0 else DEFAULT_W, DEFAULT_W) for i in range(DEFAULT_D)}
    shapes["xyz_encoding_5"] = (DEFAULT_W + IN_XYZ, DEFAULT_W)
    shapes.update(
        xyz_encoding_final=(DEFAULT_W, DEFAULT_W),
        sigma=(DEFAULT_W, 1),
        dir_encoding=(DEFAULT_W + IN_DIR, DEFAULT_W // 2),
        rgb=(DEFAULT_W // 2, 3),
    )
    params = {}
    for key, (fan_in, fan_out) in shapes.items():
        bound = 1.0 / math.sqrt(fan_in)
        params[key] = {
            "w": rng.uniform(-bound, bound, (fan_in, fan_out)).astype(np.float32),
            "b": rng.uniform(-bound, bound, (fan_out,)).astype(np.float32),
        }
    return params


def nerf_from_state(state: Dict[str, torch.Tensor], use_new_activation: bool = True) -> NeRF:
    """Build a default-width ``NeRF`` and load ``state`` into it."""
    model = NeRF(use_new_activation=use_new_activation)
    model.load_state_dict(state)
    return model
