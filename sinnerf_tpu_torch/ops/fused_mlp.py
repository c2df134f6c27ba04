"""K0: the PE + NeRF-MLP body shared by the render kernels.

Counterpart of ``sinnerf_tpu/ops/fused_mlp_t.py``: ``pack_weights_t``
(:72), ``_pe_fwd`` (:135), ``_pe_concat`` (:150) and ``mlp_from_pe`` (:189).
The CUDA routine is ``csrc/nerf_mlp.cuh``, included by the fused render
kernel (``csrc/fused_render.cu``); ``mlp_plain`` is its plain PyTorch version.

Packing.  ``pack_weights`` writes the 14 weight blocks of the split MLP into
one contiguous buffer in the compute dtype, each block (out, in) row-major
with ``in`` padded with zeros to a multiple of 16, and the 12 biases into one
float32 buffer.  The skip layer is split into ``W5h`` (trunk columns) and
``W5x`` (PE columns), the direction layer into ``Wdh`` and ``Wdx``, exactly
as ``mlp_from_pe`` splits them.  The PE columns keep the reference's
interleaved order: the kernel computes the PE in that order, so the port
needs no ``blocked_perm``.  ``WEIGHT_LAYOUT`` and ``BIAS_LAYOUT`` fix the
offsets that ``nerf_mlp.cuh`` hard-codes; a test holds the two together.

Cast points (``mlp_from_pe``): the PE is evaluated in float32 and then cast
to the compute dtype (in bf16 this rounds the xyz identity channels too);
activations are cast after every ReLU and after ``xyz_encoding_final``;
every product accumulates in float32; biases, the sigma head and the rgb and
direction epilogues stay float32.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from sinnerf_tpu_torch.core.activations import shifted_softplus, widened_sigmoid
from sinnerf_tpu_torch.models.nerf import NeRF

XYZ_CH = 63
XYZ_PAD = 64
DIR_CH = 27
DIR_PAD = 32
WIDTH = 256
HALF = 128
N_FREQS_XYZ = 10
N_FREQS_DIR = 4

# (name, out rows, padded in cols), in buffer order; offsets in nerf_mlp.cuh
WEIGHT_LAYOUT: Tuple[Tuple[str, int, int], ...] = (
    ("w1", WIDTH, XYZ_PAD),
    ("w2", WIDTH, WIDTH),
    ("w3", WIDTH, WIDTH),
    ("w4", WIDTH, WIDTH),
    ("w5h", WIDTH, WIDTH),
    ("w5x", WIDTH, XYZ_PAD),
    ("w6", WIDTH, WIDTH),
    ("w7", WIDTH, WIDTH),
    ("w8", WIDTH, WIDTH),
    ("wfin", WIDTH, WIDTH),
    ("wdh", HALF, WIDTH),
    ("wdx", HALF, DIR_PAD),
    ("wrgb", 3, HALF),
    ("wsig", 1, WIDTH),
)
BIAS_LAYOUT: Tuple[Tuple[str, int], ...] = (
    ("b1", WIDTH), ("b2", WIDTH), ("b3", WIDTH), ("b4", WIDTH),
    ("b5", WIDTH), ("b6", WIDTH), ("b7", WIDTH), ("b8", WIDTH),
    ("bfin", WIDTH), ("bd", HALF), ("brgb", 3), ("bsig", 1),
)


def _offsets(layout):
    out, off = {}, 0
    for name, *dims in layout:
        size = 1
        for d in dims:
            size *= d
        out[name] = (off, tuple(dims))
        off += size
    return out, off


WEIGHT_OFFSETS, WEIGHT_SIZE = _offsets(WEIGHT_LAYOUT)  # 594,560 elements
BIAS_OFFSETS, BIAS_SIZE = _offsets(BIAS_LAYOUT)        # 2,436 floats

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(compute_dtype: str) -> torch.dtype:
    if compute_dtype not in DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(DTYPES)}, got {compute_dtype!r}")
    return DTYPES[compute_dtype]


class PackedWeights(NamedTuple):
    w: torch.Tensor  # (WEIGHT_SIZE,) compute dtype
    b: torch.Tensor  # (BIAS_SIZE,) float32


def pack_weights(model: NeRF, dtype: torch.dtype) -> PackedWeights:
    """Split, pad and pack a default-width ``NeRF`` for the kernels."""
    if (model.depth, model.width, model.skips) != (8, WIDTH, (4,)):
        raise ValueError("the fused kernels take the reference 8x256 NeRF with the skip at layer 4")

    def w(key):
        return model.linear(key).weight.detach().float()

    def b(key):
        return model.linear(key).bias.detach().float()

    w5, wd = w("xyz_encoding_5"), w("dir_encoding")
    blocks = {
        "w1": w("xyz_encoding_1"),
        "w5h": w5[:, XYZ_CH:],
        "w5x": w5[:, :XYZ_CH],
        "wfin": w("xyz_encoding_final"),
        "wdh": wd[:, :WIDTH],
        "wdx": wd[:, WIDTH:],
        "wrgb": w("rgb"),
        "wsig": w("sigma"),
        **{f"w{i}": w(f"xyz_encoding_{i}") for i in (2, 3, 4, 6, 7, 8)},
    }
    parts = []
    for name, rows, cols in WEIGHT_LAYOUT:
        blk = blocks[name]
        assert blk.shape[0] == rows, (name, blk.shape)
        parts.append(F.pad(blk, (0, cols - blk.shape[1])).reshape(-1))
    biases = {
        **{f"b{i}": b(f"xyz_encoding_{i}") for i in range(1, 9)},
        "bfin": b("xyz_encoding_final"),
        "bd": b("dir_encoding"),
        "brgb": b("rgb"),
        "bsig": b("sigma"),
    }
    return PackedWeights(
        w=torch.cat(parts).to(dtype).contiguous(),
        b=torch.cat([biases[name] for name, _ in BIAS_LAYOUT]).contiguous(),
    )


def weight_views(packed: PackedWeights) -> Dict[str, torch.Tensor]:
    """Name -> (out, in_padded) view of a packed weight, or (out,) bias."""
    views = {}
    for name, (off, (rows, cols)) in WEIGHT_OFFSETS.items():
        views[name] = packed.w[off : off + rows * cols].view(rows, cols)
    for name, (off, (n,)) in BIAS_OFFSETS.items():
        views[name] = packed.b[off : off + n]
    return views


def pe_concat(pe: torch.Tensor, pad: int, dtype: torch.dtype) -> torch.Tensor:
    """Zero-pad float32 PE channels to ``pad`` and cast to the compute dtype."""
    return F.pad(pe.float(), (0, pad - pe.shape[-1])).to(dtype)


def mlp_plain(
    packed: PackedWeights,
    x_pe: torch.Tensor,
    d_pe: Optional[torch.Tensor],
    use_new_activation: bool = True,
    sigma_only: bool = False,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Plain version of the kernel's MLP: x_pe (P, 63) and d_pe (P, 27)
    float32 PE in the reference order -> (rgb (P, 3) or None, sigma (P,)),
    both float32.  Follows ``mlp_from_pe`` cast for cast."""
    v = weight_views(packed)
    cd = packed.w.dtype

    def dot(a, name):
        return a.float() @ v[name].float().T

    def relu_cast(y):
        return torch.relu(y).to(cd)

    x = pe_concat(x_pe, XYZ_PAD, cd)
    h = relu_cast(dot(x, "w1") + v["b1"])
    h = relu_cast(dot(h, "w2") + v["b2"])
    h = relu_cast(dot(h, "w3") + v["b3"])
    h = relu_cast(dot(h, "w4") + v["b4"])
    h = relu_cast(dot(h, "w5h") + dot(x, "w5x") + v["b5"])
    h = relu_cast(dot(h, "w6") + v["b6"])
    h = relu_cast(dot(h, "w7") + v["b7"])
    h = relu_cast(dot(h, "w8") + v["b8"])
    sigma = (dot(h, "wsig") + v["bsig"])[..., 0]
    if sigma_only:
        return None, sigma
    f = (dot(h, "wfin") + v["bfin"]).to(cd)
    d_in = pe_concat(d_pe, DIR_PAD, cd)
    a_d = dot(f, "wdh") + dot(d_in, "wdx") + v["bd"]
    d = (shifted_softplus(a_d) if use_new_activation else torch.relu(a_d)).to(cd)
    rgb = dot(d, "wrgb") + v["brgb"]
    rgb = widened_sigmoid(rgb) if use_new_activation else torch.sigmoid(rgb)
    return rgb, sigma
