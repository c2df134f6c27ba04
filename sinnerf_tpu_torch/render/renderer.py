"""Volume rendering of ray batches: coarse level, resampling, fine level.

Counterpart of ``sinnerf_tpu/render/renderer.py`` (reference
``models/rendering.py:126-335``).  ``mlp_impl`` keeps the JAX package's
values so that eval command lines carry over unchanged:

* ``"pallas"``: the hand-written kernels.  Deterministic renders
  (validation and eval) take ``fused_render_level`` (K1) per level, which
  computes no gradient; stochastic renders (training: ``perturb`` or
  ``noise_std`` set) take ``fused_render_level_train`` (K3), whose backward
  is a kernel too and reaches the models' parameters only.
  ``fused_sample_pdf_merge`` (K2) runs between the levels in both
  (``renderer.py:178-211,256-300,321-345,364-379``).  On CPU tensors the
  kernel wrappers run their plain versions.
* ``"xla"``: the plain PyTorch path, the ``NeRF`` module on the recurrence
  PE, ``composite``, ``sample_pdf`` and a sort, mirroring the JAX ``xla``
  path; autograd differentiates it with respect to rays and depths too.
  With gradients on, renders of more than ``PLAIN_CHUNK`` (2048) rays run
  in chunks that are recomputed in the backward pass.

Every random draw can be passed in as a tensor.  ``render_rays`` records
gradients when the caller has them on; ``render_chunked`` turns them off.

Outputs use the reference's result-dict schema: ``rgb_*`` (N, 3),
``depth_*`` (N,), ``opacity_*`` (N, S) per-sample weights.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from sinnerf_tpu_torch.core.composite import CompositeOut, composite
from sinnerf_tpu_torch.core.encoding import positional_encoding_recurrence
from sinnerf_tpu_torch.core.sampling import sample_pdf, stratified_z_vals
from sinnerf_tpu_torch.models.nerf import NeRF
from sinnerf_tpu_torch.ops.fused_mlp import torch_dtype
from sinnerf_tpu_torch.ops.fused_render import fused_render_level
from sinnerf_tpu_torch.ops.fused_render_train import PLAIN_CHUNK, fused_render_level_train
from sinnerf_tpu_torch.ops.fused_sample_pdf import fused_sample_pdf_merge

N_FREQS_XYZ = 10  # models/sinnerf.py:133
N_FREQS_DIR = 4   # models/sinnerf.py:134
MLP_IMPLS = ("pallas", "xla")


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Render configuration; names and defaults as in the JAX
    ``RenderSettings`` (``renderer.py:38-83``)."""

    n_samples: int = 64
    n_importance: int = 128
    use_disp: bool = False
    perturb: float = 1.0
    noise_std: float = 1.0
    white_back: bool = False
    detach_coarse: bool = False  # no gradient reaches the coarse model
    use_new_activation: bool = True
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    mlp_impl: str = "pallas"  # 'pallas': CUDA kernels | 'xla': plain PyTorch

    def __post_init__(self):
        if self.mlp_impl not in MLP_IMPLS:
            raise ValueError(f"mlp_impl must be one of {MLP_IMPLS}, got {self.mlp_impl!r}")
        torch_dtype(self.compute_dtype)

    def eval_mode(self) -> "RenderSettings":
        """Deterministic settings for validation and eval."""
        return dataclasses.replace(self, perturb=0.0, noise_std=0.0)


def _plain_level(
    model: NeRF,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    z_vals: torch.Tensor,
    settings: RenderSettings,
    noise: Optional[torch.Tensor],
    detach_params: bool = False,
) -> CompositeOut:
    """One level on the plain path: NeRF on every sample, then composite."""
    cd = torch_dtype(settings.compute_dtype)
    params = {k: v.detach() if detach_params else v for k, v in model.named_parameters()}

    def run(o, d, z, nz):
        n, s = z.shape
        xyz = o[:, None, :] + d[:, None, :] * z[..., None]
        x_pe = positional_encoding_recurrence(xyz, N_FREQS_XYZ)
        d_pe = positional_encoding_recurrence(d, N_FREQS_DIR)
        d_pe = d_pe[:, None, :].expand(n, s, d_pe.shape[-1])
        kwargs = dict(compute_dtype=None if cd == torch.float32 else cd)
        out = torch.func.functional_call(model, params, (x_pe, d_pe), kwargs)
        if nz is not None:
            nz = settings.noise_std * nz
        return tuple(composite(out[..., 0:3], out[..., 3], z, d, noise=nz, white_back=settings.white_back))

    n = z_vals.shape[0]
    if not torch.is_grad_enabled() or n <= PLAIN_CHUNK:
        return CompositeOut(*run(rays_o, rays_d, z_vals, noise))
    outs = []
    for i in range(0, n, PLAIN_CHUNK):
        c = slice(i, i + PLAIN_CHUNK)
        nz = None if noise is None else noise[c]
        outs.append(checkpoint(run, rays_o[c], rays_d[c], z_vals[c], nz, use_reentrant=False))
    return CompositeOut(*(torch.cat(parts) for parts in zip(*outs)))


def _normal(shape, like: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def render_rays(
    models: Dict[str, NeRF],
    rays: torch.Tensor,
    settings: RenderSettings = RenderSettings(),
    perturb_u: Optional[torch.Tensor] = None,
    noise_coarse: Optional[torch.Tensor] = None,
    pdf_u: Optional[torch.Tensor] = None,
    noise_fine: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """Render rays (N, 8) ``[o, d, near, far]`` (d unnormalized) with
    ``models = {'coarse': NeRF, 'fine': NeRF}`` (fine optional when
    ``n_importance == 0``), all on the rays' device.

    Random draws, used only when ``perturb`` or ``noise_std`` is set:
    ``perturb_u`` (N, n_samples) uniforms, ``noise_coarse`` (N, n_samples)
    and ``noise_fine`` (N, n_samples + n_importance) standard normals,
    ``pdf_u`` (N, n_importance) uniforms; any draw not passed comes from
    ``generator``.

    On the kernel path the result is differentiable with respect to the
    models' parameters only, and only when the render is stochastic.
    """
    stochastic = settings.perturb > 0 or settings.noise_std > 0
    kernels = settings.mlp_impl == "pallas"
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    z_vals = stratified_z_vals(
        near, far, settings.n_samples, settings.use_disp, settings.perturb, u=perturb_u, generator=generator
    )

    def level(model, z, noise, detach_params=False):
        if settings.noise_std > 0 and noise is None:
            noise = _normal(z.shape, z, generator)
        if not kernels:
            return tuple(_plain_level(model, rays_o, rays_d, z, settings, noise, detach_params))
        if not stochastic:
            return fused_render_level(
                model, rays, z, settings.use_new_activation, settings.white_back, settings.compute_dtype
            )
        return fused_render_level_train(
            model, rays, z, settings.noise_std * noise if settings.noise_std > 0 else None,
            settings.use_new_activation, settings.white_back, settings.compute_dtype, detach_params,
        )

    result: Dict[str, torch.Tensor] = {}
    rgb_c, depth_c, weights_c = level(models["coarse"], z_vals, noise_coarse, settings.detach_coarse)
    result.update(rgb_coarse=rgb_c, depth_coarse=depth_c, opacity_coarse=weights_c)

    if settings.n_importance > 0:
        det = settings.perturb == 0
        # no gradient reaches the coarse weights through the resampling
        # (reference rendering.py:311-313)
        z_det, w_det = z_vals.detach(), weights_c.detach()
        if kernels:
            if not det and pdf_u is None:
                pdf_u = torch.rand((rays.shape[0], settings.n_importance), generator=generator,
                                   dtype=z_vals.dtype, device=z_vals.device)
            z_all = fused_sample_pdf_merge(z_det, w_det, settings.n_importance, None if det else pdf_u, det)
        else:
            z_mid = 0.5 * (z_det[:, :-1] + z_det[:, 1:])
            z_fine = sample_pdf(
                z_mid, w_det[:, 1:-1], settings.n_importance, det=det, u=pdf_u,
                generator=generator, sorted_u=True,
            ).detach()
            z_all = torch.sort(torch.cat([z_vals, z_fine], dim=-1), dim=-1).values
        rgb_f, depth_f, weights_f = level(models["fine"], z_all, noise_fine)
        result.update(rgb_fine=rgb_f, depth_fine=depth_f, opacity_fine=weights_f)
    else:
        # rendering.py:330-333: fine aliases coarse when N_importance == 0
        result.update(rgb_fine=rgb_c, depth_fine=depth_c, opacity_fine=weights_c)
    return result


@torch.no_grad()
def render_chunked(
    models: Dict[str, NeRF],
    rays: torch.Tensor,
    settings: RenderSettings,
    tile: int = 32768,
) -> Dict[str, torch.Tensor]:
    """Deterministic whole-image rendering in tiles of ``tile`` rays.

    The JAX version pads the rays to a tile multiple for ``lax.map``; rays
    are independent, so here the last tile is simply shorter and renders no
    padding.
    """
    eval_settings = settings.eval_mode()
    outs = [render_rays(models, rays[i : i + tile], eval_settings) for i in range(0, rays.shape[0], tile)]
    return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}


def pick_val_tile(n_rays: int, chunk: int, n_devices: int = 1) -> int:
    """A per-run tile for image-sized renders (JAX ``pick_val_tile``)."""
    per_device = -(-n_rays // n_devices)
    rounded = -(-per_device // 256) * 256
    return max(256, min(chunk, rounded))
