"""K1: fused per-ray render of one level, PE + MLP + online compositing.

Counterpart of ``sinnerf_tpu/ops/fused_render_t.py::fused_render_level``
(:124), whose TPU kernel is ``_render_kernel`` (:61).  The CUDA kernels are
the Hopper ones of ``csrc/fused_render_sm90.cu``, one per compute dtype:

* bfloat16: the K3-fwd kernel without noise and residuals
  (``render_level_sm90.cuh::train_fwd_sm90<false>``) on the ``wgmma`` body
  of ``mlp_wgmma.cuh``, weights as ``sm90_layout.slab_buffer``;
* float32: FFMA in float32 on ``mlp_f32_sm90.cuh``, weights as
  ``sm90_layout.slab_buffer_f32``.

Their source notes give the bound (operations: 1.19 MFLOP per point) and
what each design does about it; both need an ``sm_90`` card.
``launch_render_block64`` launches the earlier kernel
(``csrc/fused_render.cu``: 64-ray blocks on ``render_level.cuh`` and the
wmma / FMA bodies of ``nerf_mlp.cuh``), which ``chip_smoke.py`` times beside
the Hopper kernels; no path of the port runs it.
``render_level_plain`` is the plain PyTorch version.

``fused_render_level`` is a ``torch.autograd.Function`` over the module's 24
float32 parameters, the rays and the depths.  Its forward is the kernel on
CUDA tensors (it launches or raises, and adds one to
``fused_render_level.launches`` and to its weights' dtype's entry of
``fused_render_level.launches_by_dtype`` per launch) and the plain version on CPU
tensors.  Its backward is JAX's ``_frl_bwd`` (:229): it recomputes the
level through the per-point K4 (``fused_mlp.fused_nerf_mlp``) on
``xyz = o + d z`` and ``composite`` (no noise, the same white background),
and differentiates that, so a render that only validates costs one kernel
and a deterministic training render gets gradients for the parameters, the
rays and the depths.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from sinnerf_tpu_torch.core.composite import composite
from sinnerf_tpu_torch.core.encoding import positional_encoding_recurrence
from sinnerf_tpu_torch.models.nerf import NeRF
from sinnerf_tpu_torch.ops import _build, sm90_layout
from sinnerf_tpu_torch.ops.fused_mlp import (
    N_FREQS_DIR,
    N_FREQS_XYZ,
    WEIGHT_SIZE,
    PackedWeights,
    _PointMLP,
    mlp_plain,
    pack_tensors,
    param_tensors,
    torch_dtype,
)

SOURCE = "fused_render_sm90.cu"
SOURCE_BLOCK64 = "fused_render.cu"  # the earlier kernel


def _check_inputs(model: NeRF, rays_od: torch.Tensor, z_vals: torch.Tensor) -> None:
    if rays_od.dim() != 2 or rays_od.shape[1] < 6:
        raise ValueError(f"rays_od must be (N, >=6) [o, d, ...], got {tuple(rays_od.shape)}")
    if z_vals.dim() != 2 or z_vals.shape[0] != rays_od.shape[0]:
        raise ValueError(f"z_vals must be (N, S) with N = {rays_od.shape[0]}, got {tuple(z_vals.shape)}")
    if rays_od.dtype != torch.float32 or z_vals.dtype != torch.float32:
        raise TypeError("rays_od and z_vals must be float32")
    if z_vals.shape[1] < 1:
        raise ValueError("z_vals needs at least one sample per ray")
    weight_device = model.linear("xyz_encoding_1").weight.device
    if not (rays_od.device == z_vals.device == weight_device):
        raise ValueError(
            f"rays ({rays_od.device}), z_vals ({z_vals.device}) and the model "
            f"({weight_device}) must be on one device"
        )


def _render_plain(packed: PackedWeights, rays6, z_vals, use_new_activation, white_back):
    n, s = z_vals.shape
    o, d = rays6[:, 0:3], rays6[:, 3:6]
    xyz = o[:, None, :] + d[:, None, :] * z_vals[..., None]  # (N, S, 3)
    x_pe = positional_encoding_recurrence(xyz, N_FREQS_XYZ).reshape(n * s, -1)
    d_pe = positional_encoding_recurrence(d, N_FREQS_DIR)  # once per ray
    d_pe = d_pe[:, None, :].expand(n, s, d_pe.shape[-1]).reshape(n * s, -1)
    rgb, sigma = mlp_plain(packed, x_pe, d_pe, use_new_activation)
    comp = composite(rgb.view(n, s, 3), sigma.view(n, s), z_vals, d, white_back=white_back)
    return comp.rgb, comp.depth, comp.weights


def render_level_plain(
    model: NeRF,
    rays_od: torch.Tensor,
    z_vals: torch.Tensor,
    use_new_activation: bool = True,
    white_back: bool = False,
    compute_dtype: str = "float32",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: the kernel's PE, MLP and cast points on every point at
    once, then ``composite``.  Returns (rgb (N, 3), depth (N,), weights (N, S))."""
    packed = pack_tensors(param_tensors(model), torch_dtype(compute_dtype))
    return _render_plain(packed, rays_od[:, 0:6], z_vals, use_new_activation, white_back)


def render_level_recompute(params, rays6, z_vals, use_new_activation, white_back, compute_dtype):
    """The level composed of the per-point K4 and ``composite``, as JAX's
    ``_ref_render_level`` (``fused_render_t.py:203-219``): differentiable
    with respect to the 24 parameters, the rays and the depths."""
    n, s = z_vals.shape
    o, d = rays6[:, 0:3], rays6[:, 3:6]
    xyz = (o[:, None, :] + d[:, None, :] * z_vals[..., None]).reshape(n * s, 3)
    dirs = d[:, None, :].expand(n, s, 3).reshape(n * s, 3)
    out = _PointMLP.apply(xyz, dirs, False, use_new_activation, compute_dtype, *params).view(n, s, 4)
    comp = composite(out[..., 0:3], out[..., 3], z_vals, d, white_back=white_back)
    return comp.rgb, comp.depth, comp.weights


_signature_set = False
_block64_signature_set = False


def _lib() -> ctypes.CDLL:
    global _signature_set
    lib = _build.load(SOURCE)
    if not _signature_set:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.k1_sm90.argtypes = [p] * 7 + [i] * 6 + [p]
        lib.k1_sm90.restype = i
        for name in ("k1_sm90_smem_bytes", "k1_sm90_threads", "k1_sm90_slab_elems"):
            getattr(lib, name).argtypes = [i]
            getattr(lib, name).restype = i
        L = sm90_layout
        got = tuple((lib.k1_sm90_smem_bytes(b), lib.k1_sm90_threads(b), lib.k1_sm90_slab_elems(b)) for b in (1, 0))
        want = ((L.FWD_SMEM, L.THREADS, L.SLAB_BUFFER_SIZE), (L.K1_F32_SMEM, L.F32_THREADS, L.SLAB_BUFFER_F32_SIZE))
        if got != want:
            raise RuntimeError(f"csrc/fused_render_sm90.cu and ops/sm90_layout.py disagree: {got} != {want}")
        _signature_set = True
    return lib


def _lib_block64() -> ctypes.CDLL:
    global _block64_signature_set
    lib = _build.load(SOURCE_BLOCK64)
    if not _block64_signature_set:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_render_level.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
        lib.fused_render_level.restype = i
        lib.nerf_packed_weight_size.argtypes = []
        lib.nerf_packed_weight_size.restype = i
        if lib.nerf_packed_weight_size() != WEIGHT_SIZE:
            raise RuntimeError("csrc/nerf_mlp.cuh and ops/fused_mlp.py disagree on the weight layout")
        _block64_signature_set = True
    return lib


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def require_sm90(capability: Tuple[int, int]) -> None:
    """Raise unless ``capability`` (a card's compute capability) is Hopper's
    9.0, the only target the Hopper kernels are built for."""
    if tuple(capability) != (9, 0):
        raise RuntimeError(f"the Hopper kernels need an sm_90 card, this one is sm_{capability[0]}{capability[1]}")


def _outputs(n, s, dev):
    return (torch.empty((n, 3), dtype=torch.float32, device=dev), torch.empty((n,), dtype=torch.float32, device=dev),
            torch.empty((n, s), dtype=torch.float32, device=dev))


def launch_render(packed: PackedWeights, rays6, z, use_new_activation, white_back):
    """K1 on CUDA tensors, the Hopper kernel of the weights' dtype: (rgb (N, 3),
    depth (N,), weights (N, S))."""
    n, s = z.shape
    dev = z.device
    require_sm90(torch.cuda.get_device_capability(dev))
    bf16 = packed.w.dtype == torch.bfloat16
    slabs = sm90_layout.slab_buffer(packed) if bf16 else sm90_layout.slab_buffer_f32(packed)
    plan = sm90_layout.k1_launch_plan(n, s, _sm_count(dev), "bfloat16" if bf16 else "float32")
    rgb, depth, weights = _outputs(n, s, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.k1_sm90(
            rays6.data_ptr(), z.data_ptr(), slabs.data_ptr(), packed.b.data_ptr(),
            rgb.data_ptr(), depth.data_ptr(), weights.data_ptr(),
            n, s, plan["ctas"], int(bf16), int(use_new_activation), int(white_back),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, rc, "fused_render_level")
    fused_render_level.launches += 1
    fused_render_level.launches_by_dtype["bfloat16" if bf16 else "float32"] += 1
    return rgb, depth, weights


def launch_render_block64(packed: PackedWeights, rays6, z, use_new_activation, white_back):
    """The earlier K1 (``csrc/fused_render.cu``: 64-ray blocks, wmma in
    bfloat16, FMA in float32) on CUDA tensors: (rgb (N, 3), depth (N,),
    weights (N, S)).  Off every path: ``chip_smoke.py`` times it beside the
    Hopper kernels and holds it against the plain version."""
    n, s = z.shape
    rgb, depth, weights = _outputs(n, s, z.device)
    lib = _lib_block64()
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        rc = lib.fused_render_level(
            rays6.data_ptr(), z.data_ptr(), packed.w.data_ptr(), packed.b.data_ptr(),
            rgb.data_ptr(), depth.data_ptr(), weights.data_ptr(),
            n, s, int(packed.w.dtype == torch.bfloat16), int(use_new_activation), int(white_back), stream,
        )
    _build.check(lib, rc, "fused_render_level (block64)")
    launch_render_block64.launches += 1
    return rgb, depth, weights


launch_render_block64.launches = 0


class _Render(torch.autograd.Function):
    """(rays6, z, flags, *24 parameters) -> (rgb, depth, weights); the
    backward recomputes through K4 and ``composite``."""

    @staticmethod
    def forward(ctx, rays6, z, use_new_activation, white_back, compute_dtype, *params):
        packed = pack_tensors(params, torch_dtype(compute_dtype))
        if z.device.type == "cuda":
            out = launch_render(packed, rays6, z, use_new_activation, white_back)
        else:
            out = _render_plain(packed, rays6, z, use_new_activation, white_back)
        ctx.save_for_backward(rays6, z, *params)
        ctx.flags = (use_new_activation, white_back, compute_dtype)
        return out

    @staticmethod
    def backward(ctx, *grads):
        rays6, z, *params = ctx.saved_tensors
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need) for t, need in zip((rays6, z, *params), needs[:2] + needs[5:])]
            outs = render_level_recompute(inputs[2:], inputs[0], inputs[1], *ctx.flags)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
            wanted = [t for t in inputs if t.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs], allow_unused=True))
        res = [next(got) if t.requires_grad else None for t in inputs]
        return (res[0], res[1], None, None, None, *res[2:])


def fused_render_level(
    model: NeRF,
    rays_od: torch.Tensor,
    z_vals: torch.Tensor,
    use_new_activation: bool = True,
    white_back: bool = False,
    compute_dtype: str = "float32",
    detach_params: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Render one level of a ray batch.  rays_od (N, >=6) float32 ``[o, d]``
    (d unnormalized), z_vals (N, S) float32 ascending.  Returns
    (rgb (N, 3), depth (N,), weights (N, S)), all float32, differentiable
    with respect to the model's parameters (unless ``detach_params``), the
    rays and the depths."""
    _check_inputs(model, rays_od, z_vals)
    if rays_od.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_render_level runs on cpu or cuda, not {rays_od.device}")
    params = param_tensors(model)
    if detach_params:
        params = tuple(p.detach() for p in params)
    return _Render.apply(rays_od[:, 0:6].contiguous(), z_vals.contiguous(), use_new_activation, white_back,
                         compute_dtype, *params)


fused_render_level.launches = 0
fused_render_level.launches_by_dtype = {"bfloat16": 0, "float32": 0}
