"""K3: the training render of one level, forward and backward.

Counterpart of ``sinnerf_tpu/ops/fused_render_train_t.py::
fused_render_level_train`` (:599), whose TPU kernels are ``_train_fwd_kernel``
(:86) and ``_train_bwd_kernel`` (:164).  Two pairs of CUDA kernels, by
compute dtype:

* bfloat16: ``csrc/fused_render_train_sm90.cu``, Hopper kernels on
  ``wgmma`` with the weights streamed through shared memory by bulk copies
  (``mlp_wgmma.cuh``, ``render_level_sm90.cuh``,
  ``mlp_backward_wgmma.cuh``); they read the weights as
  ``sm90_layout.slab_buffer`` lays them out, once per call;
* float32: ``csrc/f32_train_sm90.cu``, Hopper kernels on FFMA in full
  float32 with the weights streamed through shared memory by bulk copies:
  the forward is K1 f32's kernel with noise and residuals
  (``render_f32_sm90.cuh``), the backward ``mlp_backward_f32_sm90.cuh``;
  they read the weights as ``sm90_layout.slab_buffer_f32`` lays them out,
  once per call, and the backward's dgrad reads ``pack_weights``' own rows.

Both pairs need an ``sm_90`` card.

The source notes give the bound (operations: 1.19 MFLOP per point forward,
3.48 MFLOP backward) and what each design does about the weights, the
activations and the 2.4 MB gradient accumulator that fit in no block.
``launch_train_fwd_block64`` launches the earlier forward
(``fused_render_train.cu``: ``nvcuda::wmma`` in bfloat16, FMA in float32)
and ``launch_train_bwd_block64`` the earlier float32 backward of the same file;
no path runs them, and ``chip_smoke.py`` times them beside the Hopper ones.

``fused_render_level_train`` is a ``torch.autograd.Function`` over the
module's 24 float32 parameters: it casts them to the compute dtype inside
and returns float32 gradients, so no gradient passes a ``.to(bfloat16)``
node.  Rays, depths and noise are detached before the ``Function`` and get no
gradient, as the JAX wrapper stops theirs.  On CUDA tensors both directions
launch their kernels or raise, and add one to ``launch_train_fwd.launches``
and ``launch_train_bwd.launches`` per launch, and to their weights' dtype's
entry of ``launches_by_dtype``.  On CPU tensors they take the
plain versions:

* ``render_level_train_plain``: the forward, cast for cast with the kernel,
  differentiable by autograd, in chunks of rays;
* ``render_level_train_backward_plain``: the backward kernel step by step
  (composite adjoint by a downward and an upward sweep, MLP recompute,
  ``fused_mlp.mlp_backward_plain``).

The backward kernel adds each ray tile's sums into one accumulator with
atomics, so its gradients differ in their last bits from run to run.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from sinnerf_tpu_torch.core.composite import compute_alphas_weights, intervals
from sinnerf_tpu_torch.core.encoding import positional_encoding_recurrence
from sinnerf_tpu_torch.models.nerf import NeRF
from sinnerf_tpu_torch.ops import _build, sm90_layout
from sinnerf_tpu_torch.ops.fused_mlp import (
    BIAS_SIZE,
    _lib_f32,
    DIR_PAD,
    HALF,
    N_FREQS_DIR,
    N_FREQS_XYZ,
    WEIGHT_SIZE,
    PackedWeights,
    _chunks,
    _ptr,
    mlp_backward_plain,
    mlp_plain,
    pack_grads,
    pack_tensors,
    pack_weights,
    param_tensors,
    torch_dtype,
    unpack_grads,
)
from sinnerf_tpu_torch.ops.fused_render import _check_inputs, _sm_count, require_sm90

SOURCE = "fused_render_train.cu"
SOURCE_SM90 = "fused_render_train_sm90.cu"
PLAIN_CHUNK = 2048  # rays per pass of a plain version: bounds its (P, 256) activations


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _forward_plain(packed, dtype, rays6, z, noise, use_new_activation, white_back, keep=None):
    """One chunk of rays: (rgb, depth, weights, alphas, rgb_s (N, S, 3))."""
    n, s = z.shape
    o, d = rays6[:, 0:3], rays6[:, 3:6]
    xyz = o[:, None, :] + d[:, None, :] * z[..., None]
    x_pe = positional_encoding_recurrence(xyz, N_FREQS_XYZ).reshape(n * s, -1)
    d_pe = positional_encoding_recurrence(d, N_FREQS_DIR)  # once per ray
    d_pe = d_pe[:, None, :].expand(n, s, d_pe.shape[-1]).reshape(n * s, -1)
    rgb_s, sigma = mlp_plain(packed, x_pe, d_pe, use_new_activation, compute_dtype=dtype, keep=keep)
    rgb_s, sigma = rgb_s.view(n, s, 3), sigma.view(n, s)
    alphas, weights = compute_alphas_weights(sigma, z, d, noise)
    rgb = torch.sum(weights[..., None] * rgb_s, dim=-2)
    depth = torch.sum(weights * z, dim=-1)
    if white_back:
        rgb = rgb + (1.0 - torch.sum(weights, dim=-1, keepdim=True))
    return rgb, depth, weights, alphas, rgb_s


@torch.no_grad()
def render_level_train_forward_plain(packed, rays6, z, noise, use_new_activation=True, white_back=False,
                                     chunk=PLAIN_CHUNK):
    """Plain version of the forward kernel with its residuals, from weights
    packed in the compute dtype: (rgb, depth, weights, alphas (N, S),
    rgb_s (N, S, 3)).  No gradients; ``render_level_train_plain`` has them."""
    outs = [
        _forward_plain(packed, packed.w.dtype, rays6[c], z[c], None if noise is None else noise[c],
                       use_new_activation, white_back)
        for c in _chunks(z.shape[0], chunk)
    ]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def render_level_train_plain(
    model: NeRF,
    rays_od: torch.Tensor,
    z_vals: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    use_new_activation: bool = True,
    white_back: bool = False,
    compute_dtype: str = "float32",
    chunk: int = PLAIN_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel, differentiable by autograd with
    respect to the model's parameters: (rgb (N, 3), depth (N,), weights
    (N, S)).  Runs ``chunk`` rays at a time; with gradients on and more than
    one chunk, each chunk is recomputed in the backward pass and the
    parameter gradients of the chunks add up."""
    dtype = torch_dtype(compute_dtype)
    packed = pack_weights(model, dtype, differentiable=True)
    rays6 = rays_od[:, 0:6]

    def run(w, b, r, zz, nz):
        return _forward_plain(PackedWeights(w, b), dtype, r, zz, nz, use_new_activation, white_back)[:3]

    pieces = _chunks(z_vals.shape[0], chunk)
    recompute = torch.is_grad_enabled() and len(pieces) > 1
    outs = []
    for c in pieces:
        args = (packed.w, packed.b, rays6[c], z_vals[c], None if noise is None else noise[c])
        outs.append(checkpoint(run, *args, use_reentrant=False) if recompute else run(*args))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def composite_adjoint(z, weights, alphas, rgb_s, g_rgb, g_depth, g_w, white_back=False) -> torch.Tensor:
    """dL/dalpha (N, S) of the compositing from its residuals and the
    cotangents of (rgb, depth, weights), as the backward kernel computes it:
    ``c_s T_s - S_s / max(1 - a_s + 1e-10, 1e-10)`` with the suffix sums S_s
    by a downward sweep and the transmittance T_s by an upward one
    (``fused_render_train_t.py:26-29``)."""
    n, s = z.shape
    cot = g_rgb[:, None, 0] * rgb_s[..., 0] + g_rgb[:, None, 1] * rgb_s[..., 1] + g_rgb[:, None, 2] * rgb_s[..., 2]
    cot = cot + g_depth[:, None] * z + g_w
    if white_back:
        cot = cot - ((g_rgb[:, 0] + g_rgb[:, 1]) + g_rgb[:, 2])[:, None]
    one_minus = 1.0 - alphas
    # stage A, downwards: -S_s / u_s with S_s the suffix sum of c_j w_j
    part = torch.empty_like(z)
    suffix = torch.zeros(n, dtype=torch.float32, device=z.device)
    for i in range(s - 1, -1, -1):
        part[:, i] = -suffix / torch.clamp(one_minus[:, i] + 1e-10, min=1e-10)
        suffix = suffix + cot[:, i] * weights[:, i]
    # stage B, upwards: the transmittance rebuilt by its own product
    trans = torch.empty_like(z)
    running = torch.ones(n, dtype=torch.float32, device=z.device)
    for i in range(s):
        trans[:, i] = running
        running = running * (one_minus[:, i] + 1e-10)
    return cot * trans + part


@torch.no_grad()
def render_level_train_backward_plain(
    packed: PackedWeights,
    rays6: torch.Tensor,
    z: torch.Tensor,
    noise: Optional[torch.Tensor],
    weights: torch.Tensor,
    alphas: torch.Tensor,
    rgb_s: torch.Tensor,
    g_rgb: torch.Tensor,
    g_depth: torch.Tensor,
    g_w: torch.Tensor,
    use_new_activation: bool = True,
    white_back: bool = False,
    chunk: int = PLAIN_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel, step by step
    (``fused_render_train_t.py:26-29``, stage A :221-246, stage B :274-376).

    ``packed`` holds the weights in the compute dtype; weights, alphas (N, S)
    and rgb_s (N, S, 3) are the forward's residuals; g_rgb (N, 3), g_depth
    (N,), g_w (N, S) the cotangents.  Returns the packed float32 gradient
    buffers (dw (594,560,), db (2,436,)).  ``noise`` enters only the gate
    ``[sigma + noise > 0]``: alpha comes from the residuals."""
    dtype = packed.w.dtype
    dw = torch.zeros(WEIGHT_SIZE, dtype=torch.float32, device=z.device)
    db = torch.zeros(BIAS_SIZE, dtype=torch.float32, device=z.device)
    for c in _chunks(z.shape[0], chunk):
        zc, wc = z[c], weights[c]
        n, s = zc.shape
        da_alpha = composite_adjoint(zc, wc, alphas[c], rgb_s[c], g_rgb[c], g_depth[c], g_w[c], white_back)
        kept = {}
        nz = None if noise is None else noise[c]
        _forward_plain(packed, dtype, rays6[c], zc, nz, use_new_activation, white_back, keep=kept)
        sig = kept["sigma"].view(n, s)  # the gate reads the recomputed sigma
        if nz is not None:
            sig = sig + nz
        dsig = da_alpha * (1.0 - alphas[c]) * intervals(zc, rays6[c][:, 3:6])
        dsig = torch.where(sig > 0, dsig, torch.zeros_like(dsig))
        g_rgb_s = wc[..., None] * g_rgb[c][:, None, :]
        grads, da_d = mlp_backward_plain(
            packed, kept, g_rgb_s.reshape(n * s, 3), dsig.reshape(n * s), use_new_activation
        )
        # the direction-PE block: one float32 product per ray of the summed delta
        dad = da_d.float().view(n, s, HALF).sum(1)
        d_in = kept["d_in"].view(n, s, DIR_PAD)[:, 0].float()
        grads["wdx"] = dad.T @ d_in
        cw, cb = pack_grads(grads)
        dw += cw
        db += cb
    return dw, db


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

_signature_set = False
_sm90_signature_set = False


def _lib() -> ctypes.CDLL:
    global _signature_set
    lib = _build.load(SOURCE)
    if not _signature_set:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_render_level_train_fwd.argtypes = [p] * 10 + [i] * 5 + [p]
        lib.fused_render_level_train_fwd.restype = i
        lib.fused_render_level_train_bwd.argtypes = [p] * 15 + [i] * 6 + [p]
        lib.fused_render_level_train_bwd.restype = i
        lib.fused_render_level_train_bwd_scratch_bytes.argtypes = [i]
        lib.fused_render_level_train_bwd_scratch_bytes.restype = ctypes.c_longlong
        lib.nerf_packed_weight_size.argtypes = []
        lib.nerf_packed_weight_size.restype = i
        if lib.nerf_packed_weight_size() != WEIGHT_SIZE:
            raise RuntimeError("csrc/nerf_mlp.cuh and ops/fused_mlp.py disagree on the weight layout")
        _signature_set = True
    return lib


def _lib_sm90() -> ctypes.CDLL:
    global _sm90_signature_set
    lib = _build.load(SOURCE_SM90)
    if not _sm90_signature_set:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.k3_sm90_fwd.argtypes = [p] * 10 + [i] * 5 + [p]
        lib.k3_sm90_fwd.restype = i
        lib.k3_sm90_bwd.argtypes = [p] * 15 + [i] * 5 + [p]
        lib.k3_sm90_bwd.restype = i
        lib.k3_sm90_bwd_ablated.argtypes = [p] * 15 + [i] * 6 + [p]
        lib.k3_sm90_bwd_ablated.restype = i
        lib.k3_sm90_probe.argtypes = [i] + [p] * 5
        lib.k3_sm90_probe.restype = i
        lib.k3_sm90_smem_bytes.argtypes = [i]
        lib.k3_sm90_smem_bytes.restype = i
        lib.k3_sm90_scratch_bytes.argtypes = []
        lib.k3_sm90_scratch_bytes.restype = ctypes.c_longlong
        lib.k3_sm90_slab_elems.argtypes = []
        lib.k3_sm90_slab_elems.restype = i
        L = sm90_layout
        got = (lib.k3_sm90_smem_bytes(0), lib.k3_sm90_smem_bytes(1), lib.k3_sm90_scratch_bytes(),
               lib.k3_sm90_slab_elems())
        if got != (L.FWD_SMEM, L.BWD_SMEM, L.BWD_SCRATCH, L.SLAB_BUFFER_SIZE):
            raise RuntimeError(f"csrc/fused_render_train_sm90.cu and ops/sm90_layout.py disagree: {got}")
        _sm90_signature_set = True
    return lib


def _slabs(packed: PackedWeights, slabs: Optional[torch.Tensor]) -> torch.Tensor:
    """The Hopper kernels' weight layout for the weights' dtype, unless given."""
    if slabs is not None:
        return slabs
    return sm90_layout.slab_buffer(packed) if packed.w.dtype == torch.bfloat16 else sm90_layout.slab_buffer_f32(packed)


def _forward_outputs(n, s, dev):
    return tuple(torch.empty(shape, dtype=torch.float32, device=dev)
                 for shape in ((n, 3), (n,), (n, s), (n, s), (n, s, 3)))


def _launch_fwd_block64(packed, rays6, z, noise, use_new_activation, white_back):
    """fused_render_train.cu's forward kernel (64-point blocks: FMA in float32, wmma in
    bfloat16): (rgb, depth, weights, alphas, rgb_s)."""
    n, s = z.shape
    dev = z.device
    out = _forward_outputs(n, s, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.fused_render_level_train_fwd(
            rays6.data_ptr(), z.data_ptr(), _ptr(noise), packed.w.data_ptr(), packed.b.data_ptr(),
            *(o.data_ptr() for o in out), n, s, int(packed.w.dtype == torch.bfloat16), int(use_new_activation),
            int(white_back), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, rc, "fused_render_level_train (forward)")
    return out


def launch_train_fwd(packed, rays6, z, noise, use_new_activation, white_back, slabs=None):
    """K3-fwd on CUDA tensors, the Hopper kernel of the weights' dtype: (rgb,
    depth, weights, alphas, rgb_s).  ``slabs``: the weights' slab buffer
    (``_slabs``), built here when not given."""
    n, s = z.shape
    dev = z.device
    require_sm90(torch.cuda.get_device_capability(dev))
    bf16 = packed.w.dtype == torch.bfloat16
    slabs = _slabs(packed, slabs)
    out = _forward_outputs(n, s, dev)
    lib = _lib_sm90() if bf16 else _lib_f32()
    with torch.cuda.device(dev):
        rc = (lib.k3_sm90_fwd if bf16 else lib.k3_f32_fwd)(
            rays6.data_ptr(), z.data_ptr(), _ptr(noise), slabs.data_ptr(), packed.b.data_ptr(),
            *(o.data_ptr() for o in out), n, s, sm90_layout.launch_plan(n, s, _sm_count(dev))["ctas"],
            int(use_new_activation), int(white_back), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, rc, f"fused_render_level_train (forward, sm90, {packed.w.dtype})")
    launch_train_fwd.launches += 1
    launch_train_fwd.launches_by_dtype["bfloat16" if bf16 else "float32"] += 1
    return out


launch_train_fwd.launches = 0
launch_train_fwd.launches_by_dtype = {"bfloat16": 0, "float32": 0}


def launch_train_fwd_block64(packed, rays6, z, noise, use_new_activation, white_back):
    """The earlier K3-fwd (``fused_render_train.cu``: 64-ray blocks, wmma from
    L2 in bfloat16, FMA in float32) on CUDA tensors: (rgb, depth, weights,
    alphas, rgb_s).  Off the main path: ``chip_smoke.py`` holds it against
    the plain forward and times it beside the Hopper kernels."""
    out = _launch_fwd_block64(packed, rays6, z, noise, use_new_activation, white_back)
    launch_train_fwd_block64.launches += 1
    return out


launch_train_fwd_block64.launches = 0


def _bwd_buffers(n, s, dev):
    """dsig_part, dw and db of a K3-bwd launch (dw and db zeroed: the kernels add into them)."""
    return (torch.empty((n, s), dtype=torch.float32, device=dev),
            torch.zeros(WEIGHT_SIZE, dtype=torch.float32, device=dev),
            torch.zeros(BIAS_SIZE, dtype=torch.float32, device=dev))


def _launch_bwd_sm90(entry, extra, packed, rays6, z, noise, weights, alphas, rgb_s, g_rgb, g_depth, g_w,
                     use_new_activation, white_back, slabs):
    """A Hopper K3-bwd entry point (``extra``: its arguments after
    white_back): of ``fused_render_train_sm90.cu`` for bfloat16 weights, of
    ``f32_train_sm90.cu`` for float32, which also reads the packed weights.
    Returns (dw, db)."""
    n, s = z.shape
    dev = z.device
    require_sm90(torch.cuda.get_device_capability(dev))
    bf16 = packed.w.dtype == torch.bfloat16
    dsig_part, dw, db = _bwd_buffers(n, s, dev)
    slabs = _slabs(packed, slabs)
    lib = _lib_sm90() if bf16 else _lib_f32()
    if bf16:  # persistent CTAs, one per SM at most
        plan, weights_in = sm90_layout.launch_plan(n, s, _sm_count(dev)), ()
    else:
        plan, weights_in = sm90_layout.f32_bwd_launch_plan(n, s, _sm_count(dev), False), (packed.w.data_ptr(),)
    scratch = torch.empty(max(plan["scratch_bytes"], 1), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            rays6.data_ptr(), z.data_ptr(), _ptr(noise), slabs.data_ptr(), *weights_in, packed.b.data_ptr(),
            weights.data_ptr(), alphas.data_ptr(), rgb_s.data_ptr(), g_rgb.data_ptr(), g_depth.data_ptr(),
            g_w.data_ptr(), dsig_part.data_ptr(), scratch.data_ptr(), dw.data_ptr(), db.data_ptr(),
            n, s, plan["ctas"], int(use_new_activation), int(white_back), *extra,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, rc, f"fused_render_level_train (backward, sm90, {entry})")
    return dw, db


def launch_train_bwd(packed, rays6, z, noise, weights, alphas, rgb_s, g_rgb, g_depth, g_w,
                     use_new_activation, white_back, slabs=None):
    """K3-bwd on CUDA tensors, the Hopper kernel of the weights' dtype: the
    packed float32 gradient buffers (dw, db)."""
    entry = "k3_sm90_bwd" if packed.w.dtype == torch.bfloat16 else "k3_f32_bwd"
    out = _launch_bwd_sm90(entry, (), packed, rays6, z, noise, weights, alphas, rgb_s, g_rgb, g_depth, g_w,
                           use_new_activation, white_back, slabs)
    launch_train_bwd.launches += 1
    launch_train_bwd.launches_by_dtype["bfloat16" if entry == "k3_sm90_bwd" else "float32"] += 1
    return out


launch_train_bwd.launches = 0
launch_train_bwd.launches_by_dtype = {"bfloat16": 0, "float32": 0}


def launch_train_bwd_block64(packed, rays6, z, noise, weights, alphas, rgb_s, g_rgb, g_depth, g_w,
                             use_new_activation, white_back):
    """The earlier float32 K3-bwd (``fused_render_train.cu``, FMA on 64-ray
    blocks through ``mlp_backward.cuh``) on CUDA tensors: (dw, db).  Off every
    path: ``chip_smoke.py`` times it beside the Hopper kernel and holds it
    against the plain version."""
    if packed.w.dtype != torch.float32:
        raise ValueError("launch_train_bwd_block64 is the earlier float32 kernel")
    n, s = z.shape
    dev = z.device
    dsig_part, dw, db = _bwd_buffers(n, s, dev)
    lib = _lib()
    blocks = _sm_count(dev)  # a persistent grid: as many blocks as the card holds at once
    scratch = torch.empty(blocks * lib.fused_render_level_train_bwd_scratch_bytes(0), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        rc = lib.fused_render_level_train_bwd(
            rays6.data_ptr(), z.data_ptr(), _ptr(noise), packed.w.data_ptr(), packed.b.data_ptr(),
            weights.data_ptr(), alphas.data_ptr(), rgb_s.data_ptr(), g_rgb.data_ptr(), g_depth.data_ptr(),
            g_w.data_ptr(), dsig_part.data_ptr(), scratch.data_ptr(), dw.data_ptr(), db.data_ptr(),
            n, s, blocks, 0, int(use_new_activation), int(white_back), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, rc, "fused_render_level_train (backward, block64)")
    launch_train_bwd_block64.launches += 1
    return dw, db


launch_train_bwd_block64.launches = 0


# The timing ablations of the Hopper K3-bwd kernels: each removes one part of
# the kernel and nothing else.  bfloat16 (csrc/mlp_backward_wgmma.cuh
# Ablate): ``flush`` the weight gradients' reductions into dw, ``wgrad`` the
# weight-gradient products and their flush.  float32
# (csrc/mlp_backward_f32_sm90.cuh Ablate): ``flush`` as in bfloat16,
# ``scratch`` the kept tiles' round trip through global memory (no stores,
# every A slab from one 64 KB region).
ABLATE = {"flush": 1, "wgrad": 2}
ABLATE_F32 = {"flush": 1, "scratch": 2}


def launch_train_bwd_ablated(part, packed, rays6, z, noise, weights, alphas, rgb_s, g_rgb, g_depth, g_w,
                             use_new_activation, white_back, slabs=None):
    """The Hopper K3-bwd without ``part`` (a key of ABLATE in bfloat16, of
    ABLATE_F32 in float32), for timing only: its own instantiation of the
    kernel, so the training path's carries no switch.  The gradients it
    returns are wrong by design."""
    bf16 = packed.w.dtype == torch.bfloat16
    entry, code = ("k3_sm90_bwd_ablated", ABLATE[part]) if bf16 else ("k3_f32_bwd_ablated", ABLATE_F32[part])
    out = _launch_bwd_sm90(entry, (code,), packed, rays6, z, noise, weights, alphas, rgb_s, g_rgb, g_depth, g_w,
                           use_new_activation, white_back, slabs)
    launch_train_bwd_ablated.launches += 1
    return out


launch_train_bwd_ablated.launches = 0


def sm90_probe(mode: int, a: torch.Tensor, c: torch.Tensor, w_slab: torch.Tensor) -> torch.Tensor:
    """One warpgroup's product through the Hopper kernels' descriptors (the
    card's tests hold it against ``sm90_probe_plain``).  a, c: (128, 256)
    bf16 CUDA tensors; w_slab: the swizzled image of a (256, 64) bf16 matrix
    (``sm90_layout.swizzle``).  mode 0: a[:64, :64] W^T (64, 256); 1:
    a[:64] W (64, 64); 2: a[:, :64]^T c (64, 256); 3: a[:, :64]^T c[:, :64]."""
    shape = {0: (64, 256), 1: (64, 64), 2: (64, 256), 3: (64, 64)}[mode]
    out = torch.zeros(shape, dtype=torch.float32, device=a.device)
    lib = _lib_sm90()
    with torch.cuda.device(a.device):
        rc = lib.k3_sm90_probe(mode, a.data_ptr(), c.data_ptr(), w_slab.data_ptr(), out.data_ptr(),
                               torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, rc, f"k3_sm90_probe mode {mode}")
    return out


def sm90_probe_plain(mode: int, a: torch.Tensor, c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of ``sm90_probe`` with the unswizzled (256, 64) ``w``."""
    a, c, w = a.float(), c.float(), w.float()
    if mode == 0:
        return a[:64, :64] @ w.T
    if mode == 1:
        return a[:64] @ w
    return a[:, :64].T @ (c if mode == 2 else c[:, :64])


class _TrainRender(torch.autograd.Function):
    """(rays6, z, noise, flags, *24 parameters) -> (rgb, depth, weights);
    gradients for the parameters only."""

    @staticmethod
    def forward(ctx, rays6, z, noise, use_new_activation, white_back, compute_dtype, *params):
        packed = pack_tensors(params, torch_dtype(compute_dtype))
        ctx.slabs = None
        if z.device.type == "cuda":
            ctx.slabs = _slabs(packed, None)  # the Hopper kernels' weight layout, once for both directions
            out = launch_train_fwd(packed, rays6, z, noise, use_new_activation, white_back, ctx.slabs)
        else:
            out = render_level_train_forward_plain(packed, rays6, z, noise, use_new_activation, white_back)
        rgb, depth, weights, alphas, rgb_s = out
        ctx.save_for_backward(rays6, z, noise, packed.w, packed.b, weights, alphas, rgb_s)
        ctx.flags = (use_new_activation, white_back)
        return rgb, depth, weights

    @staticmethod
    def backward(ctx, g_rgb, g_depth, g_w):
        rays6, z, noise, w, b, weights, alphas, rgb_s = ctx.saved_tensors
        n, s = z.shape

        def cot(g, shape):
            if g is None:
                return torch.zeros(shape, dtype=torch.float32, device=z.device)
            return g.float().contiguous()

        args = (PackedWeights(w, b), rays6, z, noise, weights, alphas, rgb_s,
                cot(g_rgb, (n, 3)), cot(g_depth, (n,)), cot(g_w, (n, s)), *ctx.flags)
        if z.device.type == "cuda":
            dw, db = launch_train_bwd(*args, slabs=ctx.slabs)
        else:
            dw, db = render_level_train_backward_plain(*args)
        return (None,) * 6 + unpack_grads(dw, db)


def fused_render_level_train(
    model: NeRF,
    rays_od: torch.Tensor,
    z_vals: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    use_new_activation: bool = True,
    white_back: bool = False,
    compute_dtype: str = "float32",
    detach_params: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training render of one level.  rays_od (N, >=6) float32 ``[o, d]`` (d
    unnormalized), z_vals (N, S) float32 ascending, noise (N, S) float32
    added to sigma before the ReLU (already scaled) or None.  Returns
    (rgb (N, 3), depth (N,), weights (N, S)), float32, differentiable with
    respect to the model's parameters only: rays, depths and noise are
    detached here.  To differentiate with respect to rays or depths use the
    plain render path (``mlp_impl="xla"``).  ``detach_params`` renders with
    the parameters detached too."""
    _check_inputs(model, rays_od, z_vals)
    if noise is not None and (noise.shape != z_vals.shape or noise.dtype != torch.float32
                              or noise.device != z_vals.device):
        raise ValueError(f"noise must be float32 {tuple(z_vals.shape)} on {z_vals.device}")
    if rays_od.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_render_level_train runs on cpu or cuda, not {rays_od.device}")
    params = param_tensors(model)
    if detach_params:
        params = tuple(p.detach() for p in params)
    return _TrainRender.apply(
        rays_od[:, 0:6].detach().contiguous(),
        z_vals.detach().contiguous(),
        None if noise is None else noise.detach().contiguous(),
        use_new_activation, white_back, compute_dtype, *params,
    )
