"""Volume rendering of ray batches: coarse level, resampling, fine level.

Counterpart of ``sinnerf_tpu/render/renderer.py`` (reference
``models/rendering.py:126-335``).  ``mlp_impl`` keeps the JAX package's
values so that command lines carry over unchanged:

* ``"pallas"``: the hand-written kernels, by the JAX package's branches
  (``renderer.py:254-408``).  Deterministic renders take
  ``fused_render_level`` (K1) per level (``fast_eval``); its backward
  recomputes through the per-point K4, so the render is differentiable with
  respect to the parameters, the rays and the depths.  Stochastic renders
  (``perturb`` or ``noise_std`` set) take ``fused_render_level_train`` (K3,
  ``fast_train``), whose backward reaches the models' parameters only.
  ``fast_eval=False`` and ``fast_train=False`` take the per-point K4
  (``fused_nerf_mlp``) and ``composite`` instead, differentiable with respect
  to the rays and the depths too; ``test_time`` renders a sigma-only coarse
  level through K4.  ``fused_sample_pdf_merge`` (K2) runs between the levels
  unless ``fast_merge=False``.  On CPU tensors the kernel wrappers run their
  plain versions.
* ``"xla"``: the plain PyTorch path, the ``NeRF`` module on the recurrence
  PE, ``composite``, ``sample_pdf`` and a sort, mirroring the JAX ``xla``
  path; autograd differentiates it with respect to rays and depths too.
  With gradients on, renders of more than ``PLAIN_CHUNK`` (2048) rays run
  in chunks that are recomputed in the backward pass.

Every random draw can be passed in as a tensor.  ``render_rays`` records
gradients when the caller has them on; ``render_chunked`` and
``render_chunked_sharded`` (one image over several ranks) turn them off.
``points_chunk`` (the JAX package's ``lax.map`` over point chunks) is not
ported: the kernels need no chunking and the plain path chunks by rays.

Outputs use the reference's result-dict schema: ``rgb_*`` (N, 3),
``depth_*`` (N,), ``opacity_*`` (N, S) per-sample weights.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from sinnerf_tpu_torch.core.composite import CompositeOut, composite, compute_weights
from sinnerf_tpu_torch.core.encoding import positional_encoding, positional_encoding_recurrence
from sinnerf_tpu_torch.core.sampling import sample_pdf, stratified_z_vals
from sinnerf_tpu_torch.models.nerf import NeRF
from sinnerf_tpu_torch.ops.fused_mlp import fused_nerf_mlp, torch_dtype
from sinnerf_tpu_torch.ops.fused_render import fused_render_level
from sinnerf_tpu_torch.ops.fused_render_train import PLAIN_CHUNK, fused_render_level_train
from sinnerf_tpu_torch.ops.fused_sample_pdf import fused_sample_pdf_merge
from sinnerf_tpu_torch.parallel import ddp

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
    test_time: bool = False  # sigma-only coarse level, no fine noise
    use_new_activation: bool = True
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    mlp_impl: str = "pallas"  # 'pallas': CUDA kernels | 'xla': plain PyTorch
    # the kernel branches (JAX renderer.py:62-80): K2 between the levels
    # (else sample_pdf with iid u and a sort), K1 for deterministic renders and
    # K3 for stochastic ones (else the per-point K4 and composite)
    fast_merge: bool = True
    fast_eval: bool = True
    fast_train: bool = True

    def __post_init__(self):
        if self.mlp_impl not in MLP_IMPLS:
            raise ValueError(f"mlp_impl must be one of {MLP_IMPLS}, got {self.mlp_impl!r}")
        torch_dtype(self.compute_dtype)

    def eval_mode(self) -> "RenderSettings":
        """Deterministic settings for validation and eval."""
        return dataclasses.replace(self, perturb=0.0, noise_std=0.0)


def _query(
    model: NeRF,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    z_vals: torch.Tensor,
    settings: RenderSettings,
    sigma_only: bool,
    detach_params: bool = False,
) -> torch.Tensor:
    """The NeRF on every sample of every ray (JAX ``_query_t``,
    ``renderer.py:86-175``): the per-point K4 on the kernel path, the
    ``NeRF`` module on the recurrence PE on the plain one.  Returns
    (N, S, 4) ``[rgb, sigma]`` or (N, S) sigma when ``sigma_only``."""
    n, s = z_vals.shape
    xyz = (rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]).reshape(n * s, 3)
    dirs = None if sigma_only else rays_d[:, None, :].expand(n, s, 3).reshape(n * s, 3)
    if settings.mlp_impl == "pallas":
        out = fused_nerf_mlp(model, xyz, dirs, sigma_only, settings.use_new_activation,
                             settings.compute_dtype, detach_params)
    else:
        cd = torch_dtype(settings.compute_dtype)
        params = {k: v.detach() if detach_params else v for k, v in model.named_parameters()}
        x_pe = positional_encoding_recurrence(xyz, N_FREQS_XYZ)
        d_pe = None if sigma_only else positional_encoding_recurrence(dirs, N_FREQS_DIR)
        kwargs = dict(sigma_only=sigma_only, compute_dtype=None if cd == torch.float32 else cd)
        out = torch.func.functional_call(model, params, (x_pe, d_pe), kwargs)
    return out.view(n, s) if sigma_only else out.view(n, s, 4)


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

    def run(o, d, z, nz):
        out = _query(model, o, d, z, settings, False, detach_params)
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

    On the kernel path a stochastic render with ``fast_train`` is
    differentiable with respect to the models' parameters only; every other
    branch with respect to the rays too.  ``test_time`` returns the coarse
    weights only and, as in JAX, renders the fine level without noise.
    """
    stochastic = (settings.perturb > 0 or settings.noise_std > 0) and not settings.test_time
    kernels = settings.mlp_impl == "pallas"
    fused_eval = kernels and settings.fast_eval and not settings.test_time and not stochastic
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    z_vals = stratified_z_vals(
        near, far, settings.n_samples, settings.use_disp, settings.perturb, u=perturb_u, generator=generator
    )

    def level(model, z, noise, detach_params=False):
        """(rgb, depth, weights) of one level (JAX renderer.py:278-317,373-408)."""
        noise_std = 0.0 if settings.test_time else settings.noise_std
        if noise_std > 0 and noise is None:
            noise = _normal(z.shape, z, generator)
        if fused_eval:
            return fused_render_level(model, rays, z, settings.use_new_activation, settings.white_back,
                                      settings.compute_dtype, detach_params)
        if kernels and settings.fast_train:
            return fused_render_level_train(
                model, rays, z, noise_std * noise if noise_std > 0 else None,
                settings.use_new_activation, settings.white_back, settings.compute_dtype, detach_params,
            )
        if noise_std == 0:
            noise = None
        if not kernels:  # _plain_level scales the noise by noise_std itself
            return tuple(_plain_level(model, rays_o, rays_d, z, settings, noise, detach_params))
        out = _query(model, rays_o, rays_d, z, settings, False, detach_params)
        nz = None if noise is None else noise_std * noise
        return tuple(composite(out[..., 0:3], out[..., 3], z, rays_d, noise=nz, white_back=settings.white_back))

    result: Dict[str, torch.Tensor] = {}
    if settings.test_time:
        # as in JAX, no sigma noise here (the reference's inference() adds it
        # even in this weights-only branch, rendering.py:224)
        sigmas = _query(models["coarse"], rays_o, rays_d, z_vals, settings, True)
        weights_c = compute_weights(sigmas, z_vals, rays_d)
        result["opacity_coarse"] = weights_c
    else:
        rgb_c, depth_c, weights_c = level(models["coarse"], z_vals, noise_coarse, settings.detach_coarse)
        result.update(rgb_coarse=rgb_c, depth_coarse=depth_c, opacity_coarse=weights_c)

    if settings.n_importance > 0:
        det = settings.perturb == 0
        # no gradient reaches the coarse weights through the resampling
        # (reference rendering.py:311-313)
        z_det, w_det = z_vals.detach(), weights_c.detach()
        if kernels and settings.fast_merge:
            if not det and pdf_u is None:
                pdf_u = torch.rand((rays.shape[0], settings.n_importance), generator=generator,
                                   dtype=z_vals.dtype, device=z_vals.device)
            z_all = fused_sample_pdf_merge(z_det, w_det, settings.n_importance, None if det else pdf_u, det)
        else:
            z_mid = 0.5 * (z_det[:, :-1] + z_det[:, 1:])
            z_fine = sample_pdf(
                z_mid, w_det[:, 1:-1], settings.n_importance, det=det, u=pdf_u,
                generator=generator, sorted_u=settings.fast_merge,
            ).detach()
            z_all = torch.sort(torch.cat([z_vals, z_fine], dim=-1), dim=-1).values
        rgb_f, depth_f, weights_f = level(models["fine"], z_all, noise_fine)
        result.update(rgb_fine=rgb_f, depth_fine=depth_f, opacity_fine=weights_f)
    elif not settings.test_time:
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


def render_chunked_sharded(
    models: Dict[str, NeRF],
    rays: torch.Tensor,
    settings: RenderSettings,
    rank: int,
    world: int,
    tile: int = 32768,
    keys: Optional[Sequence[str]] = None,
) -> Dict[str, torch.Tensor]:
    """``render_chunked`` with the ray axis sharded over ``world`` ranks
    (JAX ``render_chunked_sharded``, renderer.py:441): the rays padded to a
    multiple of ``tile * world``, each rank renders its contiguous slab of
    whole tiles, and every rank gets the whole image's outputs, those of
    ``keys`` when given (the per-sample ``opacity_*`` are most of the bytes
    to gather: 123 MB of a 400x400 image at 64 + 128 samples).  The render
    holds no collective; the gather follows it.  Every rank calls it with
    the same rays and replicated models."""
    slab, n = ddp.shard_rays(rays, rank, world, tile)
    out = render_chunked(models, slab, settings, tile)
    return ddp.gather_rays({k: out[k] for k in (keys or out)}, n, world)


def pick_val_tile(n_rays: int, chunk: int, n_devices: int = 1) -> int:
    """A per-run tile for image-sized renders (JAX ``pick_val_tile``)."""
    per_device = -(-n_rays // n_devices)
    rounded = -(-per_device // 256) * 256
    return max(256, min(chunk, rounded))


def eval_points(
    models: Dict[str, NeRF], points: torch.Tensor, settings: RenderSettings = RenderSettings()
) -> torch.Tensor:
    """Raw sigma of the fine model (the coarse one when there is no fine) at
    points (N, 3) -> (N, 1), for point-cloud extraction (JAX ``eval_points``,
    ``renderer.py:486``, reference ``rendering.py:64-123``): the exact PE and
    the ``NeRF`` module, as JAX runs it whatever ``mlp_impl`` says."""
    model = models.get("fine", models["coarse"])
    cd = torch_dtype(settings.compute_dtype)
    return model(positional_encoding(points, N_FREQS_XYZ), None, sigma_only=True,
                 compute_dtype=None if cd == torch.float32 else cd)
