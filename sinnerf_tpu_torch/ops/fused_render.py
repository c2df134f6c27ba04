"""K1: fused per-ray render of one level, PE + MLP + online compositing.

Counterpart of ``sinnerf_tpu/ops/fused_render_t.py::fused_render_level``
(:124), whose TPU kernel is ``_render_kernel`` (:61).  The CUDA kernel is
``csrc/fused_render.cu`` (body in ``csrc/render_level.cuh``, shared with the
training forward, on the K0 routines of ``csrc/nerf_mlp.cuh``); its source
note gives the bound (compute: 1.19 MFLOP per point) and what the
design does about it.  ``render_level_plain`` is the plain PyTorch version.

``fused_render_level`` is a ``torch.autograd.Function`` over the module's 24
float32 parameters, the rays and the depths.  Its forward is the kernel on
CUDA tensors (it launches or raises, and adds one to
``fused_render_level.launches`` per launch) and the plain version on CPU
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
from sinnerf_tpu_torch.ops import _build
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

SOURCE = "fused_render.cu"


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


def _lib() -> ctypes.CDLL:
    global _signature_set
    lib = _build.load(SOURCE)
    if not _signature_set:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_render_level.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
        lib.fused_render_level.restype = i
        lib.nerf_packed_weight_size.argtypes = []
        lib.nerf_packed_weight_size.restype = i
        if lib.nerf_packed_weight_size() != WEIGHT_SIZE:
            raise RuntimeError("csrc/nerf_mlp.cuh and ops/fused_mlp.py disagree on the weight layout")
        _signature_set = True
    return lib


def _launch(packed: PackedWeights, rays6, z, use_new_activation, white_back):
    """K1 on CUDA tensors: (rgb (N, 3), depth (N,), weights (N, S))."""
    n, s = z.shape
    rgb = torch.empty((n, 3), dtype=torch.float32, device=z.device)
    depth = torch.empty((n,), dtype=torch.float32, device=z.device)
    weights = torch.empty((n, s), dtype=torch.float32, device=z.device)
    lib = _lib()
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        rc = lib.fused_render_level(
            rays6.data_ptr(), z.data_ptr(), packed.w.data_ptr(), packed.b.data_ptr(),
            rgb.data_ptr(), depth.data_ptr(), weights.data_ptr(),
            n, s, int(packed.w.dtype == torch.bfloat16), int(use_new_activation), int(white_back), stream,
        )
    _build.check(lib, rc, "fused_render_level")
    fused_render_level.launches += 1
    return rgb, depth, weights


class _Render(torch.autograd.Function):
    """(rays6, z, flags, *24 parameters) -> (rgb, depth, weights); the
    backward recomputes through K4 and ``composite``."""

    @staticmethod
    def forward(ctx, rays6, z, use_new_activation, white_back, compute_dtype, *params):
        packed = pack_tensors(params, torch_dtype(compute_dtype))
        if z.device.type == "cuda":
            out = _launch(packed, rays6, z, use_new_activation, white_back)
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
