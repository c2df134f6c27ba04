"""K0, the PE + NeRF-MLP body shared by the kernels, and K4, the per-point MLP.

Counterpart of ``sinnerf_tpu/ops/fused_mlp_t.py``: ``pack_weights_t``
(:72), ``_pe_fwd`` (:135), ``_pe_concat`` (:150) and ``mlp_from_pe`` (:189)
for K0; ``fused_nerf_mlp_t`` (:543) with its kernels ``_kernel_t`` (:232)
and ``_bwd_kernel_t`` (:298) for K4.  The first CUDA routines are
``csrc/nerf_mlp.cuh`` (forward) and ``csrc/mlp_backward.cuh`` (backward),
whose constants every kernel includes; ``mlp_plain`` is the forward's plain
PyTorch version and ``mlp_backward_plain`` that of the backward's MLP body.

K4 is ``fused_nerf_mlp``, a ``torch.autograd.Function`` over the module's 24
float32 parameters with gradients for them, the points and the directions.
Which kernel each direction runs:

- forward, bfloat16: ``csrc/fused_mlp.cu`` (``nerf_mlp.cuh``, wmma on
  64-point blocks);
- forward, float32: the Hopper kernel ``k4_fwd_f32_sm90`` of
  ``csrc/f32_train_sm90.cu``, K4-bwd f32's own recompute on
  ``mlp_f32_sm90.cuh`` without keeping (FFMA over weights streamed through
  shared memory by bulk copies);
- backward, bfloat16: the Hopper kernel of ``csrc/fused_mlp_sm90.cu``, K3-bwd
  bf16's wgmma body (``mlp_backward_wgmma.cuh``) at one sample per ray with
  the input gradients as three more one-slab dgrads;
- backward, float32: the Hopper kernel ``k4_bwd_f32_sm90`` of
  ``csrc/f32_train_sm90.cu`` (``mlp_backward_f32_sm90.cuh``).

The Hopper kernels need an ``sm_90`` card.  The earlier kernels of
``csrc/fused_mlp.cu`` they replace stay built on no path, for
``chip_smoke.py``'s timing rounds: ``launch_mlp_fwd_block64`` (forward f32),
``launch_mlp_bwd_wmma`` (backward bf16) and ``launch_mlp_bwd_block64``
(backward f32).  ``nerf_mlp_plain``/``nerf_mlp_forward_plain`` and
``nerf_mlp_backward_plain`` (with ``pe_backward``) are its plain versions,
used on CPU tensors and by the tests.  The source notes give the bound
(operations: 1.19 MFLOP per point forward, 3.56 backward).

Packing.  ``pack_weights`` writes the 14 weight blocks of the split MLP into
one contiguous buffer in the compute dtype, each block (out, in) row-major
with ``in`` padded with zeros to a multiple of 16, and the 12 biases into one
float32 buffer.  The skip layer is split into ``W5h`` (trunk columns) and
``W5x`` (PE columns), the direction layer into ``Wdh`` and ``Wdx``, exactly
as ``mlp_from_pe`` splits them.  The PE columns keep the reference's
interleaved order: the kernel computes the PE in that order, so the port
needs no ``blocked_perm``.  ``WEIGHT_LAYOUT`` and ``BIAS_LAYOUT`` fix the
offsets that ``nerf_mlp.cuh`` hard-codes; a test holds the two together.
The backward kernel writes its float32 gradients in the same two layouts;
``unpack_grads`` turns them into gradients of the module's parameters.

Cast points (``mlp_from_pe``): the PE is evaluated in float32 and then cast
to the compute dtype (in bf16 this rounds the xyz identity channels too);
activations are cast after every ReLU and after ``xyz_encoding_final``;
every product accumulates in float32; biases, the sigma head and the rgb and
direction epilogues stay float32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from sinnerf_tpu_torch.core.activations import shifted_softplus, widened_sigmoid
from sinnerf_tpu_torch.core.encoding import PE_RESTART, positional_encoding_recurrence
from sinnerf_tpu_torch.models.nerf import NeRF
from sinnerf_tpu_torch.ops import _build

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


# The module's 12 layers in the order the kernels' wrappers pass them
PARAM_KEYS: Tuple[str, ...] = (
    *(f"xyz_encoding_{i}" for i in range(1, 9)),
    "xyz_encoding_final", "dir_encoding", "rgb", "sigma",
)


def param_tensors(model: NeRF) -> Tuple[torch.Tensor, ...]:
    """The 24 parameters, ``(weight, bias)`` per layer of ``PARAM_KEYS``."""
    if (model.depth, model.width, model.skips) != (8, WIDTH, (4,)):
        raise ValueError("the fused kernels take the reference 8x256 NeRF with the skip at layer 4")
    return tuple(t for key in PARAM_KEYS for t in (model.linear(key).weight, model.linear(key).bias))


class _RoundTo(torch.autograd.Function):
    """Round to ``dtype`` and return float32 again; the gradient passes
    unrounded (a ``.to(bfloat16)`` node would round it to bfloat16)."""

    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).float()

    @staticmethod
    def backward(ctx, g):
        return g, None


def pack_tensors(tensors, dtype: torch.dtype, differentiable: bool = False) -> PackedWeights:
    """Split, pad and pack the tensors of ``param_tensors``.

    By default the buffers are detached and ``w`` is stored in ``dtype``, as
    the kernels read it.  ``differentiable`` keeps the graph for the plain
    versions: ``w`` is then float32 storage holding values rounded to
    ``dtype``, and gradients reach the parameters in float32."""
    if not differentiable:
        tensors = [t.detach() for t in tensors]
    named = {key: (tensors[2 * i].float(), tensors[2 * i + 1].float()) for i, key in enumerate(PARAM_KEYS)}

    def w(key):
        return named[key][0]

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
    flat = torch.cat(parts)
    bias_of = {
        **{f"b{i}": f"xyz_encoding_{i}" for i in range(1, 9)},
        "bfin": "xyz_encoding_final", "bd": "dir_encoding", "brgb": "rgb", "bsig": "sigma",
    }
    return PackedWeights(
        w=_RoundTo.apply(flat, dtype) if differentiable else flat.to(dtype).contiguous(),
        b=torch.cat([named[bias_of[name]][1] for name, _ in BIAS_LAYOUT]).contiguous(),
    )


def pack_weights(model: NeRF, dtype: torch.dtype, differentiable: bool = False) -> PackedWeights:
    """Split, pad and pack a default-width ``NeRF`` (see ``pack_tensors``)."""
    return pack_tensors(param_tensors(model), dtype, differentiable)


def unpack_grads(dw: torch.Tensor, db: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Packed float32 gradient buffers (the layouts above) -> gradients of
    the tensors of ``param_tensors``, in their order.  Counterpart of
    ``_unpack_grads_t`` (``fused_mlp_t.py:485``): the split layers are joined
    again and the padded columns of ``w1``, ``w5x`` and ``wdx`` dropped."""
    v = weight_views(PackedWeights(dw, db))
    weights = {
        "xyz_encoding_1": v["w1"][:, :XYZ_CH],
        "xyz_encoding_5": torch.cat([v["w5x"][:, :XYZ_CH], v["w5h"]], dim=1),
        "xyz_encoding_final": v["wfin"],
        "dir_encoding": torch.cat([v["wdh"], v["wdx"][:, :DIR_CH]], dim=1),
        "rgb": v["wrgb"],
        "sigma": v["wsig"],
        **{f"xyz_encoding_{i}": v[f"w{i}"] for i in (2, 3, 4, 6, 7, 8)},
    }
    biases = {
        **{f"xyz_encoding_{i}": v[f"b{i}"] for i in range(1, 9)},
        "xyz_encoding_final": v["bfin"], "dir_encoding": v["bd"], "rgb": v["brgb"], "sigma": v["bsig"],
    }
    return tuple(t.contiguous() for key in PARAM_KEYS for t in (weights[key], biases[key]))


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
    compute_dtype: Optional[torch.dtype] = None,
    keep: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Plain version of the kernel's MLP: x_pe (P, 63) and d_pe (P, 27)
    float32 PE in the reference order -> (rgb (P, 3) or None, sigma (P,)),
    both float32.  Follows ``mlp_from_pe`` cast for cast.  ``compute_dtype``
    defaults to the dtype ``packed.w`` is stored in; a dict passed as
    ``keep`` receives what the backward needs (``x``, ``h1``..``h8``,
    ``sigma``, ``f``, ``d_in``, ``a_d``, ``d``, ``a_rgb``)."""
    v = weight_views(packed)
    cd = packed.w.dtype if compute_dtype is None else compute_dtype
    kept = {} if keep is None else keep

    def dot(a, name):
        return a.float() @ v[name].float().T

    def relu_cast(y):
        return torch.relu(y).to(cd)

    x = kept["x"] = pe_concat(x_pe, XYZ_PAD, cd)
    h = x
    for i in range(1, 9):
        a = dot(h, f"w{i}") if i != 5 else dot(h, "w5h") + dot(x, "w5x")
        h = kept[f"h{i}"] = relu_cast(a + v[f"b{i}"])
    sigma = kept["sigma"] = (dot(h, "wsig") + v["bsig"])[..., 0]
    if sigma_only:
        return None, sigma
    f = kept["f"] = (dot(h, "wfin") + v["bfin"]).to(cd)
    d_in = kept["d_in"] = pe_concat(d_pe, DIR_PAD, cd)
    a_d = kept["a_d"] = dot(f, "wdh") + dot(d_in, "wdx") + v["bd"]
    d = kept["d"] = (shifted_softplus(a_d) if use_new_activation else torch.relu(a_d)).to(cd)
    a_rgb = kept["a_rgb"] = dot(d, "wrgb") + v["brgb"]
    rgb = widened_sigmoid(a_rgb) if use_new_activation else torch.sigmoid(a_rgb)
    return rgb, sigma


def mlp_backward_plain(
    packed: PackedWeights,
    kept: Dict[str, torch.Tensor],
    g_rgb: torch.Tensor,
    g_sigma: torch.Tensor,
    use_new_activation: bool = True,
    deltas: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Plain version of the backward kernel's MLP body
    (``fused_render_train_t.py::_train_bwd_kernel``, stage B), on P points at
    once: ``kept`` from ``mlp_plain``, g_rgb (P, 3) and g_sigma (P,) float32
    cotangents of rgb and sigma -> (name -> float32 gradient of every block
    of ``WEIGHT_LAYOUT`` but ``wdx`` and every bias of ``BIAS_LAYOUT``, the
    cast delta of the direction layer (P, 128) for the caller's per-ray
    ``wdx`` product).

    Cast points as in the kernel: every delta is cast to the compute dtype
    before both of its products, ReLU masks read the cast activation, sums
    run in float32.  A dict passed as ``deltas`` receives the cast deltas of
    the two layers whose input is the PE, ``da1`` and ``da5`` (P, 256)."""
    v = weight_views(packed)
    cd = kept["x"].dtype
    deltas = {} if deltas is None else deltas
    grads: Dict[str, torch.Tensor] = {}

    def cast(t):
        return t.to(cd)

    def emit(wname, bname, delta, layer_in):  # delta (P, out), layer_in (P, in): both cast
        grads[wname] = delta.float().T @ layer_in.float()
        if bname is not None:
            grads[bname] = delta.float().sum(0)

    def back(delta, wname):  # (P, out) @ (out, in) -> (P, in), float32 sum
        return delta.float() @ v[wname].float()

    a_rgb, a_d = kept["a_rgb"], kept["a_d"]
    if use_new_activation:
        tt = torch.tanh(0.5 * a_rgb)
        dact_rgb = 0.2505 * (1.0 - tt * tt)
        slope_d = torch.sigmoid(a_d - 1.0)
    else:
        sg = torch.sigmoid(a_rgb)
        dact_rgb = sg * (1.0 - sg)
        slope_d = (a_d > 0).float()
    da_rgb = cast(g_rgb * dact_rgb)
    emit("wrgb", "brgb", da_rgb, kept["d"])
    da_d = cast(back(da_rgb, "wrgb") * slope_d)
    emit("wdh", "bd", da_d, kept["f"])
    df = cast(back(da_d, "wdh"))
    emit("wfin", "bfin", df, kept["h8"])
    g_sig = cast(g_sigma)[:, None]
    emit("wsig", "bsig", g_sig, kept["h8"])
    dh = back(df, "wfin") + back(g_sig, "wsig")
    for i in range(8, 0, -1):
        da = cast(dh * (kept[f"h{i}"].float() > 0))
        if i in (1, 5):
            deltas[f"da{i}"] = da
        if i == 5:
            emit("w5h", "b5", da, kept["h4"])
            emit("w5x", None, da, kept["x"])
            dh = back(da, "w5h")
        elif i == 1:
            emit("w1", "b1", da, kept["x"])
        else:
            emit(f"w{i}", f"b{i}", da, kept[f"h{i - 1}"])
            dh = back(da, f"w{i}")
    return grads, da_d


def pack_grads(grads: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """name -> gradient (every block and bias) -> the packed float32 buffers."""
    dw = torch.cat([grads[name].reshape(-1) for name, _, _ in WEIGHT_LAYOUT])
    db = torch.cat([grads[name].reshape(-1) for name, _ in BIAS_LAYOUT])
    return dw, db


# --------------------------------------------------------------------------
# K4: the per-point PE + MLP, forward and backward
# --------------------------------------------------------------------------

SOURCE = "fused_mlp.cu"  # K4-fwd bf16, and the earlier K4 kernels on no path
SOURCE_F32 = "f32_train_sm90.cu"  # the float32 kernels on Hopper: K4-fwd and K4-bwd here, K3 in fused_render_train
SOURCE_SM90 = "fused_mlp_sm90.cu"  # K4-bwd bf16 on Hopper
POINT_CHUNK = 1 << 18  # points per pass of a plain version: bounds its (P, 256) activations


def pe_backward(x: torch.Tensor, dpe: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """The exact adjoint of ``positional_encoding_recurrence``: x (P, C) and
    the gradient dpe (P, >= C (2F + 1)) of its interleaved PE -> dx (P, C),
    float32.  JAX ``_pe_bwd`` (``fused_mlp_t.py:160-181``) on the port's
    interleaved columns: the recurrence levels pass their gradient down to
    the level they came from, the exact levels to x."""
    x = x.float()
    c = x.shape[-1]
    sins, coss = [], []
    for k in range(n_freqs):
        if k % PE_RESTART == 0:
            xk = x * (2.0**k)
            s, co = torch.sin(xk), torch.cos(xk)
        else:
            s, co = 2.0 * s * co, 1.0 - 2.0 * s * s
        sins.append(s)
        coss.append(co)
    dx = dpe[:, :c].float()
    ds_next = dc_next = None
    for k in range(n_freqs - 1, -1, -1):
        ds = dpe[:, c + 2 * c * k : 2 * c + 2 * c * k].float()
        dc = dpe[:, 2 * c + 2 * c * k : 3 * c + 2 * c * k].float()
        if k + 1 < n_freqs and (k + 1) % PE_RESTART != 0:
            ds = ds + 2.0 * (coss[k] * ds_next) - 4.0 * (sins[k] * dc_next)
            dc = dc + 2.0 * (sins[k] * ds_next)
        if k % PE_RESTART == 0:
            dx = dx + (2.0**k) * (coss[k] * ds - sins[k] * dc)
        ds_next, dc_next = ds, dc
    return dx


def nerf_mlp_plain(
    packed: PackedWeights,
    xyz: torch.Tensor,
    dirs: Optional[torch.Tensor],
    use_new_activation: bool = True,
    sigma_only: bool = False,
    keep: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Plain version of K4-fwd: xyz (P, 3), dirs (P, 3) float32 (unread when
    ``sigma_only``) -> (P, 4) ``[rgb, sigma]`` or (P, 1) sigma, float32.  The
    recurrence PE of each point's own direction, then ``mlp_plain``, cast for
    cast with the kernel."""
    x_pe = positional_encoding_recurrence(xyz, N_FREQS_XYZ)
    d_pe = None if sigma_only else positional_encoding_recurrence(dirs, N_FREQS_DIR)
    rgb, sigma = mlp_plain(packed, x_pe, d_pe, use_new_activation, sigma_only, keep=keep)
    return sigma[:, None] if sigma_only else torch.cat([rgb, sigma[:, None]], dim=1)


def _chunks(n: int, chunk: int):
    return [slice(i, min(i + chunk, n)) for i in range(0, n, chunk)]


@torch.no_grad()
def nerf_mlp_forward_plain(packed, xyz, dirs, use_new_activation=True, sigma_only=False, chunk=POINT_CHUNK):
    """``nerf_mlp_plain`` in chunks of points, without gradients."""
    parts = [nerf_mlp_plain(packed, xyz[c], None if sigma_only else dirs[c], use_new_activation, sigma_only)
             for c in _chunks(xyz.shape[0], chunk)]
    return torch.cat(parts) if parts else xyz.new_zeros((0, 1 if sigma_only else 4))


@torch.no_grad()
def nerf_mlp_backward_plain(
    packed: PackedWeights,
    xyz: torch.Tensor,
    dirs: Optional[torch.Tensor],
    g: torch.Tensor,
    use_new_activation: bool = True,
    sigma_only: bool = False,
    chunk: int = POINT_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of K4-bwd (``_bwd_kernel_t``, ``fused_mlp_t.py:298``):
    the recompute, ``mlp_backward_plain``, the direction-PE block's gradient
    per point, and the input gradient ``W1^T da1 + W5x^T da5`` and
    ``Wdx^T da_d`` through ``pe_backward``.  g (P, 4) ``[d rgb, d sigma]``
    (P, 1) when ``sigma_only``, whose backward runs on zero directions with
    zero rgb cotangents as JAX's does.  Returns the packed float32 gradient
    buffers (dw, db), dxyz (P, 3) and ddir (P, 3) or None."""
    dw = torch.zeros(WEIGHT_SIZE, dtype=torch.float32, device=xyz.device)
    db = torch.zeros(BIAS_SIZE, dtype=torch.float32, device=xyz.device)
    dxyz = torch.empty_like(xyz, dtype=torch.float32)
    ddir = None if sigma_only else torch.empty_like(xyz, dtype=torch.float32)
    v = weight_views(packed)
    for c in _chunks(xyz.shape[0], chunk):
        x = xyz[c]
        d = torch.zeros_like(x) if sigma_only else dirs[c]
        kept: Dict[str, torch.Tensor] = {}
        nerf_mlp_plain(packed, x, d, use_new_activation, keep=kept)
        g_rgb = torch.zeros_like(x) if sigma_only else g[c, 0:3].float()
        deltas: Dict[str, torch.Tensor] = {}
        grads, da_d = mlp_backward_plain(packed, kept, g_rgb, g[c, -1].float(), use_new_activation, deltas)
        grads["wdx"] = da_d.float().T @ kept["d_in"].float()
        dxpe = deltas["da1"].float() @ v["w1"].float() + deltas["da5"].float() @ v["w5x"].float()
        dxyz[c] = pe_backward(x, dxpe, N_FREQS_XYZ)
        if ddir is not None:
            ddir[c] = pe_backward(d, da_d.float() @ v["wdx"].float(), N_FREQS_DIR)
        cw, cb = pack_grads(grads)
        dw += cw
        db += cb
    return dw, db, dxyz, ddir


_signature_set = False


def _lib() -> ctypes.CDLL:
    global _signature_set
    lib = _build.load(SOURCE)
    if not _signature_set:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_nerf_mlp_fwd.argtypes = [p] * 5 + [i] * 4 + [p]
        lib.fused_nerf_mlp_fwd.restype = i
        lib.fused_nerf_mlp_bwd.argtypes = [p] * 10 + [i] * 4 + [p]
        lib.fused_nerf_mlp_bwd.restype = i
        lib.fused_nerf_mlp_bwd_scratch_bytes.argtypes = [i]
        lib.fused_nerf_mlp_bwd_scratch_bytes.restype = ctypes.c_longlong
        lib.nerf_packed_weight_size.argtypes = []
        lib.nerf_packed_weight_size.restype = i
        if lib.nerf_packed_weight_size() != WEIGHT_SIZE:
            raise RuntimeError("csrc/nerf_mlp.cuh and ops/fused_mlp.py disagree on the weight layout")
        _signature_set = True
    return lib


_f32_signature_set = False


def _lib_f32() -> ctypes.CDLL:
    """``csrc/f32_train_sm90.cu``, its signatures set and its layout held
    against ``ops/sm90_layout.py``."""
    global _f32_signature_set
    from sinnerf_tpu_torch.ops import sm90_layout as L

    lib = _build.load(SOURCE_F32)
    if not _f32_signature_set:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.k3_f32_fwd.argtypes = [p] * 10 + [i] * 5 + [p]
        lib.k3_f32_fwd.restype = i
        lib.k3_f32_bwd.argtypes = [p] * 16 + [i] * 5 + [p]
        lib.k3_f32_bwd.restype = i
        lib.k3_f32_bwd_ablated.argtypes = [p] * 16 + [i] * 6 + [p]
        lib.k3_f32_bwd_ablated.restype = i
        lib.k4_f32_bwd.argtypes = [p] * 11 + [i] * 3 + [p]
        lib.k4_f32_bwd.restype = i
        lib.k4_f32_fwd.argtypes = [p] * 5 + [i] * 4 + [p]
        lib.k4_f32_fwd.restype = i
        for name in ("f32_sm90_smem_bytes", "f32_bwd_slabs", "k4_f32_fwd_slabs"):
            getattr(lib, name).argtypes = [i]
            getattr(lib, name).restype = i
        lib.f32_bwd_scratch_bytes.argtypes = []
        lib.f32_bwd_scratch_bytes.restype = ctypes.c_longlong
        lib.f32_slab_elems.argtypes = []
        lib.f32_slab_elems.restype = i
        got = (lib.f32_sm90_smem_bytes(0), lib.f32_sm90_smem_bytes(1), lib.f32_bwd_scratch_bytes(),
               lib.f32_bwd_slabs(0), lib.f32_bwd_slabs(1), lib.f32_slab_elems(), lib.k4_f32_fwd_slabs(0),
               lib.k4_f32_fwd_slabs(1))
        want = (L.K1_F32_SMEM, L.F32_BWD_SMEM, L.F32_BWD_SCRATCH, len(L.f32_bwd_slabs(False)),
                len(L.f32_bwd_slabs(True)), L.SLAB_BUFFER_F32_SIZE, len(L.F32_SLABS), L.K4_F32_SIGMA_SLABS)
        if got != want:
            raise RuntimeError(f"csrc/f32_train_sm90.cu and ops/sm90_layout.py disagree: {got} != {want}")
        _f32_signature_set = True
    return lib


_sm90_signature_set = False


def _lib_sm90() -> ctypes.CDLL:
    """``csrc/fused_mlp_sm90.cu``, its signatures set and its shared memory,
    scratch, slab buffer and slab order held against ``ops/sm90_layout.py``."""
    global _sm90_signature_set
    from sinnerf_tpu_torch.ops import sm90_layout as L

    lib = _build.load(SOURCE_SM90)
    if not _sm90_signature_set:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.k4_sm90_bwd.argtypes = [p] * 10 + [i] * 3 + [p]
        lib.k4_sm90_bwd.restype = i
        lib.k4_sm90_bwd_ablated.argtypes = [p] * 10 + [i] * 4 + [p]
        lib.k4_sm90_bwd_ablated.restype = i
        for name in ("k4_sm90_smem_bytes", "k4_sm90_slab_elems"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        lib.k4_sm90_scratch_bytes.argtypes = []
        lib.k4_sm90_scratch_bytes.restype = ctypes.c_longlong
        lib.k4_sm90_bwd_slab.argtypes = [i]
        lib.k4_sm90_bwd_slab.restype = i
        order = []
        while lib.k4_sm90_bwd_slab(len(order)) >= 0:
            order.append(lib.k4_sm90_bwd_slab(len(order)))
        got = (lib.k4_sm90_smem_bytes(), lib.k4_sm90_scratch_bytes(), lib.k4_sm90_slab_elems(), tuple(order))
        want = (L.BWD_SMEM, L.K4_BWD_SCRATCH, L.SLAB_BUFFER_SIZE, L.K4_BWD_SLABS)
        if got != want:
            raise RuntimeError(f"csrc/fused_mlp_sm90.cu and ops/sm90_layout.py disagree: {got} != {want}")
        _sm90_signature_set = True
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _hopper_sms(dev) -> int:
    """The SM count of ``dev``, after raising unless it is an ``sm_90`` card
    (the Hopper kernels' only target)."""
    from sinnerf_tpu_torch.ops.fused_render import _sm_count, require_sm90

    require_sm90(torch.cuda.get_device_capability(dev))
    return _sm_count(dev)


def launch_mlp_fwd(packed: PackedWeights, xyz, dirs, use_new_activation=True, sigma_only=False) -> torch.Tensor:
    """K4-fwd on CUDA tensors: (P, 4) ``[rgb, sigma]`` or (P, 1) sigma.
    float32 weights run the Hopper kernel of ``csrc/f32_train_sm90.cu`` (K4-bwd
    f32's recompute on ``mlp_f32_sm90.cuh``; needs an ``sm_90`` card),
    bfloat16 the wmma kernel of ``csrc/fused_mlp.cu``."""
    if packed.w.dtype == torch.float32:
        from sinnerf_tpu_torch.ops import sm90_layout as L

        n, dev = xyz.shape[0], xyz.device
        sms = _hopper_sms(dev)
        out = torch.empty((n, 1 if sigma_only else 4), dtype=torch.float32, device=dev)
        slabs = L.slab_buffer_f32(packed)
        lib = _lib_f32()
        with torch.cuda.device(dev):
            rc = lib.k4_f32_fwd(
                xyz.data_ptr(), None if sigma_only else dirs.data_ptr(), slabs.data_ptr(), packed.b.data_ptr(),
                out.data_ptr(), n, L.k4_fwd_f32_launch_plan(n, sms, sigma_only)["ctas"], int(sigma_only),
                int(use_new_activation), torch.cuda.current_stream(dev).cuda_stream,
            )
        _build.check(lib, rc, "fused_nerf_mlp (forward, f32 sm90)")
    else:
        out = _launch_fwd_block64(packed, xyz, dirs, use_new_activation, sigma_only)
    launch_mlp_fwd.launches += 1
    return out


launch_mlp_fwd.launches = 0


def _launch_fwd_block64(packed: PackedWeights, xyz, dirs, use_new_activation, sigma_only) -> torch.Tensor:
    """``csrc/fused_mlp.cu``'s K4-fwd (64-point blocks; wmma in bfloat16, FMA
    in float32): (P, 4) or (P, 1)."""
    n = xyz.shape[0]
    out = torch.empty((n, 1 if sigma_only else 4), dtype=torch.float32, device=xyz.device)
    lib = _lib()
    with torch.cuda.device(xyz.device):
        rc = lib.fused_nerf_mlp_fwd(
            xyz.data_ptr(), None if sigma_only else dirs.data_ptr(), packed.w.data_ptr(), packed.b.data_ptr(),
            out.data_ptr(), n, int(packed.w.dtype == torch.bfloat16), int(sigma_only), int(use_new_activation),
            torch.cuda.current_stream(xyz.device).cuda_stream,
        )
    _build.check(lib, rc, "fused_nerf_mlp (forward)")
    return out


def launch_mlp_fwd_block64(packed: PackedWeights, xyz, dirs, use_new_activation=True, sigma_only=False):
    """The earlier float32 K4-fwd (``csrc/fused_mlp.cu``, FMA on 64-point
    blocks) on CUDA tensors.  Off every path: ``chip_smoke.py`` times it
    beside the Hopper kernel and holds it against the plain version."""
    if packed.w.dtype != torch.float32:
        raise ValueError("launch_mlp_fwd_block64 is the earlier float32 kernel; bfloat16 runs it on the path")
    out = _launch_fwd_block64(packed, xyz, dirs, use_new_activation, sigma_only)
    launch_mlp_fwd_block64.launches += 1
    return out


launch_mlp_fwd_block64.launches = 0


def _bwd_args(packed: PackedWeights, xyz, g, sigma_only):
    """The cotangent as (P, 4) (zero rgb part when ``sigma_only``) and the
    zeroed dw, db and the dxyz, ddir outputs of a K4-bwd launch."""
    n, dev = xyz.shape[0], xyz.device
    g4 = g.float()
    if sigma_only:
        g4 = torch.cat([torch.zeros((n, 3), dtype=torch.float32, device=dev), g4[:, -1:]], dim=1)
    return (g4.contiguous(), torch.zeros(WEIGHT_SIZE, dtype=torch.float32, device=dev),
            torch.zeros(BIAS_SIZE, dtype=torch.float32, device=dev), torch.empty((n, 3), dtype=torch.float32, device=dev),
            None if sigma_only else torch.empty((n, 3), dtype=torch.float32, device=dev))


def _launch_bwd_sm90(packed: PackedWeights, xyz, dirs, g, use_new_activation, sigma_only, ablate: int = 0):
    """K4-bwd bf16 on Hopper (``csrc/fused_mlp_sm90.cu``): (dw, db, dxyz, ddir
    or None); ``ablate`` 1 drops the dW flush (timing only)."""
    from sinnerf_tpu_torch.ops import sm90_layout as L

    n, dev = xyz.shape[0], xyz.device
    plan = L.k4_bwd_launch_plan(n, _hopper_sms(dev))
    g4, dw, db, dxyz, ddir = _bwd_args(packed, xyz, g, sigma_only)
    slabs = L.slab_buffer(packed)
    scratch = torch.empty(max(plan["scratch_bytes"], 1), dtype=torch.uint8, device=dev)
    lib = _lib_sm90()
    args = (xyz.data_ptr(), None if sigma_only else dirs.data_ptr(), slabs.data_ptr(), packed.b.data_ptr(),
            g4.data_ptr(), scratch.data_ptr(), dw.data_ptr(), db.data_ptr(), dxyz.data_ptr(), _ptr(ddir), n,
            plan["ctas"], int(use_new_activation))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.k4_sm90_bwd_ablated(*args, ablate, stream) if ablate else lib.k4_sm90_bwd(*args, stream)
    _build.check(lib, rc, "fused_nerf_mlp (backward, bf16 sm90)")
    return dw, db, dxyz, ddir


def launch_mlp_bwd(packed: PackedWeights, xyz, dirs, g, use_new_activation=True, sigma_only=False):
    """K4-bwd on CUDA tensors: (dw, db, dxyz, ddir or None) as
    ``nerf_mlp_backward_plain`` returns them.  Both dtypes run Hopper kernels
    (they need an ``sm_90`` card): bfloat16 ``csrc/fused_mlp_sm90.cu``
    (``mlp_backward_wgmma.cuh``), float32 ``csrc/f32_train_sm90.cu``
    (``mlp_backward_f32_sm90.cuh``)."""
    if packed.w.dtype == torch.bfloat16:
        out = _launch_bwd_sm90(packed, xyz, dirs, g, use_new_activation, sigma_only)
    else:
        from sinnerf_tpu_torch.ops import sm90_layout as L

        n, dev = xyz.shape[0], xyz.device
        plan = L.f32_bwd_launch_plan(n, 1, _hopper_sms(dev), True)
        g4, dw, db, dxyz, ddir = _bwd_args(packed, xyz, g, sigma_only)
        slabs = L.slab_buffer_f32(packed)
        scratch = torch.empty(max(plan["scratch_bytes"], 1), dtype=torch.uint8, device=dev)
        lib = _lib_f32()
        with torch.cuda.device(dev):
            rc = lib.k4_f32_bwd(
                xyz.data_ptr(), None if sigma_only else dirs.data_ptr(), slabs.data_ptr(), packed.w.data_ptr(),
                packed.b.data_ptr(), g4.data_ptr(), scratch.data_ptr(), dw.data_ptr(), db.data_ptr(), dxyz.data_ptr(),
                _ptr(ddir), n, plan["ctas"], int(use_new_activation), torch.cuda.current_stream(dev).cuda_stream,
            )
        _build.check(lib, rc, "fused_nerf_mlp (backward, f32 sm90)")
        out = dw, db, dxyz, ddir
    launch_mlp_bwd.launches += 1
    return out


launch_mlp_bwd.launches = 0


def launch_mlp_bwd_ablated(packed: PackedWeights, xyz, dirs, g, use_new_activation=True, sigma_only=False):
    """The bfloat16 K4-bwd without its weight gradients' reductions into dW
    (``ABL_FLUSH``), for timing only: the gradients are then wrong.  Off every
    path and counted by no launch count."""
    if packed.w.dtype != torch.bfloat16:
        raise ValueError("launch_mlp_bwd_ablated times the bfloat16 Hopper kernel")
    return _launch_bwd_sm90(packed, xyz, dirs, g, use_new_activation, sigma_only, ablate=1)


def _launch_bwd_block64(packed: PackedWeights, xyz, dirs, g, use_new_activation, sigma_only):
    """``csrc/fused_mlp.cu``'s K4-bwd (64-point blocks; wmma in bfloat16, FMA
    in float32): (dw, db, dxyz, ddir or None)."""
    n = xyz.shape[0]
    dev = xyz.device
    bf16 = packed.w.dtype == torch.bfloat16
    lib = _lib()
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count * (2 if bf16 else 1)
    scratch = torch.empty(blocks * lib.fused_nerf_mlp_bwd_scratch_bytes(int(bf16)), dtype=torch.uint8, device=dev)
    g4, dw, db, dxyz, ddir = _bwd_args(packed, xyz, g, sigma_only)
    with torch.cuda.device(dev):
        rc = lib.fused_nerf_mlp_bwd(
            xyz.data_ptr(), None if sigma_only else dirs.data_ptr(), packed.w.data_ptr(), packed.b.data_ptr(),
            g4.data_ptr(), scratch.data_ptr(), dw.data_ptr(), db.data_ptr(), dxyz.data_ptr(), _ptr(ddir),
            n, blocks, int(bf16), int(use_new_activation), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, rc, "fused_nerf_mlp (backward)")
    return dw, db, dxyz, ddir


def launch_mlp_bwd_block64(packed: PackedWeights, xyz, dirs, g, use_new_activation=True, sigma_only=False):
    """The earlier float32 K4-bwd (``csrc/fused_mlp.cu``, FMA on 64-point
    blocks) on CUDA tensors: (dw, db, dxyz, ddir or None).  Off every path:
    ``chip_smoke.py`` times it beside the Hopper kernel and holds it against
    the plain version."""
    if packed.w.dtype != torch.float32:
        raise ValueError("launch_mlp_bwd_block64 is the earlier float32 kernel; bfloat16 runs it on the path")
    out = _launch_bwd_block64(packed, xyz, dirs, g, use_new_activation, sigma_only)
    launch_mlp_bwd_block64.launches += 1
    return out


launch_mlp_bwd_block64.launches = 0


def launch_mlp_bwd_wmma(packed: PackedWeights, xyz, dirs, g, use_new_activation=True, sigma_only=False):
    """The earlier bfloat16 K4-bwd (``csrc/fused_mlp.cu``, wmma on 64-point
    blocks) on CUDA tensors: (dw, db, dxyz, ddir or None).  Off every path:
    ``chip_smoke.py`` times it beside the Hopper kernel and holds it against
    the plain version."""
    if packed.w.dtype != torch.bfloat16:
        raise ValueError("launch_mlp_bwd_wmma is the earlier bfloat16 kernel; float32 has its own")
    out = _launch_bwd_block64(packed, xyz, dirs, g, use_new_activation, sigma_only)
    launch_mlp_bwd_wmma.launches += 1
    return out


launch_mlp_bwd_wmma.launches = 0


class _PointMLP(torch.autograd.Function):
    """(xyz, dirs, flags, *24 parameters) -> (P, 4) or (P, 1); gradients for
    the parameters, xyz and dirs."""

    @staticmethod
    def forward(ctx, xyz, dirs, sigma_only, use_new_activation, compute_dtype, *params):
        packed = pack_tensors(params, torch_dtype(compute_dtype))
        if xyz.device.type == "cuda":
            out = launch_mlp_fwd(packed, xyz, dirs, use_new_activation, sigma_only)
        else:
            out = nerf_mlp_forward_plain(packed, xyz, dirs, use_new_activation, sigma_only)
        ctx.save_for_backward(xyz, dirs, packed.w, packed.b)
        ctx.flags = (use_new_activation, sigma_only)
        return out

    @staticmethod
    def backward(ctx, g):
        xyz, dirs, w, b = ctx.saved_tensors
        use_new_activation, sigma_only = ctx.flags
        args = (PackedWeights(w, b), xyz, dirs, g.float().contiguous(), use_new_activation, sigma_only)
        if xyz.device.type == "cuda":
            dw, db, dxyz, ddir = launch_mlp_bwd(*args)
        else:
            dw, db, dxyz, ddir = nerf_mlp_backward_plain(*args)
        return (dxyz, ddir, None, None, None) + unpack_grads(dw, db)


def fused_nerf_mlp(
    model: NeRF,
    xyz: torch.Tensor,
    dirs: Optional[torch.Tensor] = None,
    sigma_only: bool = False,
    use_new_activation: bool = True,
    compute_dtype: str = "float32",
    detach_params: bool = False,
) -> torch.Tensor:
    """PE + NeRF MLP per point (JAX ``fused_nerf_mlp_t``, row-major): xyz
    (P, 3) and dirs (P, 3) float32 (None when ``sigma_only``) -> (P, 4)
    ``[rgb, sigma]`` or (P, 1) sigma, float32.  Differentiable with respect
    to the model's parameters (float32 gradients; the ``Function`` casts the
    parameters inside), xyz and dirs.  On CUDA tensors both directions launch
    their kernels or raise, and add one to ``launch_mlp_fwd.launches`` and
    ``launch_mlp_bwd.launches`` per launch; on CPU tensors they take the
    plain versions."""
    if xyz.dim() != 2 or xyz.shape[1] != 3 or xyz.dtype != torch.float32:
        raise ValueError(f"xyz must be (P, 3) float32, got {tuple(xyz.shape)} {xyz.dtype}")
    if not sigma_only and (dirs is None or dirs.shape != xyz.shape or dirs.dtype != torch.float32):
        raise ValueError("dirs must be (P, 3) float32 like xyz unless sigma_only")
    weight_device = model.linear("xyz_encoding_1").weight.device
    if xyz.device != weight_device or (dirs is not None and dirs.device != xyz.device):
        raise ValueError(f"xyz ({xyz.device}), dirs and the model ({weight_device}) must be on one device")
    if xyz.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_nerf_mlp runs on cpu or cuda, not {xyz.device}")
    params = param_tensors(model)
    if detach_params:
        params = tuple(p.detach() for p in params)
    return _PointMLP.apply(xyz.contiguous(), None if sigma_only else dirs.contiguous(), sigma_only,
                           use_new_activation, compute_dtype, *params)
