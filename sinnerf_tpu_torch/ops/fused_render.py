"""K1: fused per-ray render of one level, PE + MLP + online compositing.

Counterpart of ``sinnerf_tpu/ops/fused_render_t.py::fused_render_level``
(:124), whose TPU kernel is ``_render_kernel`` (:61).  The CUDA kernel is
``csrc/fused_render.cu`` (body in ``csrc/render_level.cuh``, shared with the
training forward, on the K0 routines of ``csrc/nerf_mlp.cuh``); its source
note gives the bound (compute: 1.19 MFLOP per point) and what the
design does about it.  ``render_level_plain`` is the plain PyTorch version.

The wrapper takes the plain version only for CPU tensors.  On CUDA tensors it
launches the kernel or raises, and adds one to ``fused_render_level.launches``
per launch.  It computes no gradients (the eval path never differentiates).
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
    mlp_plain,
    pack_weights,
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
    packed = pack_weights(model, torch_dtype(compute_dtype))
    n, s = z_vals.shape
    o, d = rays_od[:, 0:3], rays_od[:, 3:6]
    xyz = o[:, None, :] + d[:, None, :] * z_vals[..., None]  # (N, S, 3)
    x_pe = positional_encoding_recurrence(xyz, N_FREQS_XYZ).reshape(n * s, -1)
    d_pe = positional_encoding_recurrence(d, N_FREQS_DIR)  # once per ray
    d_pe = d_pe[:, None, :].expand(n, s, d_pe.shape[-1]).reshape(n * s, -1)
    rgb, sigma = mlp_plain(packed, x_pe, d_pe, use_new_activation)
    comp = composite(rgb.view(n, s, 3), sigma.view(n, s), z_vals, d, white_back=white_back)
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


@torch.no_grad()
def fused_render_level(
    model: NeRF,
    rays_od: torch.Tensor,
    z_vals: torch.Tensor,
    use_new_activation: bool = True,
    white_back: bool = False,
    compute_dtype: str = "float32",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Render one level of a ray batch.  rays_od (N, >=6) float32 ``[o, d]``
    (d unnormalized), z_vals (N, S) float32 ascending.  Returns
    (rgb (N, 3), depth (N,), weights (N, S)), all float32."""
    _check_inputs(model, rays_od, z_vals)
    if rays_od.device.type == "cpu":
        return render_level_plain(model, rays_od, z_vals, use_new_activation, white_back, compute_dtype)
    if rays_od.device.type != "cuda":
        raise ValueError(f"fused_render_level runs on cpu or cuda, not {rays_od.device}")
    dtype = torch_dtype(compute_dtype)
    packed = pack_weights(model, dtype)
    rays6 = rays_od[:, 0:6].contiguous()
    z = z_vals.contiguous()
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
            n, s, int(dtype == torch.bfloat16), int(use_new_activation), int(white_back), stream,
        )
    _build.check(lib, rc, "fused_render_level")
    fused_render_level.launches += 1
    return rgb, depth, weights


fused_render_level.launches = 0
