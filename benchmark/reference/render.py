"""Volume rendering on plain PyTorch: the reference for the port's renderer.

Coarse level, resampling, fine level, as ``sinnerf_tpu_torch.render.
renderer.render_rays`` defines them with its kernels' semantics: exact
positional encoding, the NeRF MLP, compositing with the sigma noise given,
the importance samples drawn from the coarse weights by inverse CDF at
stratified uniforms ``(k + u_k) / K`` (deterministic renders: ``linspace(0,
1, K)``) and merged with the coarse depths by a sort.  Every draw is passed
in.  Gradient renders run in chunks of ``CHUNK`` rays that are recomputed in
the backward pass, so a step's 18,776 rays x 192 samples fit; ``render_image``
renders in blocks with gradients off.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, Optional

import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference.composite import composite
from benchmark.reference.encoding import positional_encoding
from benchmark.reference.nerf import NeRF
from benchmark.reference.sampling import sample_pdf, stratified_z_vals

N_FREQS_XYZ = 10
N_FREQS_DIR = 4
CHUNK = 2048  # rays per recomputed chunk of a gradient render
IMAGE_BLOCK = 8192  # rays per block of a whole-image render


@dataclasses.dataclass(frozen=True)
class Settings:
    n_samples: int = 64
    n_importance: int = 64
    perturb: float = 1.0
    noise_std: float = 1.0
    white_back: bool = False
    precision: Optional[str] = None  # nerf.round_to's: None is float32


@contextlib.contextmanager
def plain_matmuls(conv_tf32: bool = False) -> Iterator[None]:
    """float32 matmuls in float32 (TF32 off) while the block runs, restored
    after; convolutions in TF32 only with ``conv_tf32``, as PyTorch's
    default (``torch.backends.cudnn.allow_tf32``) runs the discriminator's."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = conv_tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _level(model: NeRF, rays: torch.Tensor, z: torch.Tensor, noise: Optional[torch.Tensor], s: Settings):
    """(rgb, depth, weights) of one level over rays (N, 8) at depths z (N, S)."""
    o, d = rays[:, 0:3], rays[:, 3:6]
    n, k = z.shape
    xyz = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(n * k, 3)
    dirs = d[:, None, :].expand(n, k, 3).reshape(n * k, 3)
    out = model(positional_encoding(xyz, N_FREQS_XYZ), positional_encoding(dirs, N_FREQS_DIR),
                precision=s.precision).view(n, k, 4)
    nz = None if noise is None or s.noise_std == 0 else s.noise_std * noise
    return tuple(composite(out[..., 0:3], out[..., 3], z, d, noise=nz, white_back=s.white_back))


def _render(models: Dict[str, NeRF], rays, s: Settings, perturb_u, noise_coarse, pdf_u, noise_fine):
    det = s.perturb == 0
    z = stratified_z_vals(rays[:, 6:7], rays[:, 7:8], s.n_samples, False, s.perturb, u=perturb_u)
    rgb_c, depth_c, w_c = _level(models["coarse"], rays, z, noise_coarse, s)
    z_mid = 0.5 * (z[:, :-1] + z[:, 1:])
    z_fine = sample_pdf(z_mid.detach(), w_c.detach()[:, 1:-1], s.n_importance, det=det, u=pdf_u,
                        sorted_u=True).detach()
    z_all = torch.sort(torch.cat([z.detach(), z_fine], dim=-1), dim=-1).values
    rgb_f, depth_f, w_f = _level(models["fine"], rays, z_all, noise_fine, s)
    return rgb_c, depth_c, w_c, rgb_f, depth_f, w_f


KEYS = ("rgb_coarse", "depth_coarse", "opacity_coarse", "rgb_fine", "depth_fine", "opacity_fine")


def render_rays(models: Dict[str, NeRF], rays: torch.Tensor, s: Settings, perturb_u=None, noise_coarse=None,
                pdf_u=None, noise_fine=None) -> Dict[str, torch.Tensor]:
    """The renderer's result dict for rays (N, 8) ``[o, d, near, far]``;
    differentiable with respect to the models' parameters, in recomputed
    chunks of ``CHUNK`` rays."""
    draws = (perturb_u, noise_coarse, pdf_u, noise_fine)
    outs = []
    for i in range(0, rays.shape[0], CHUNK):
        c = slice(i, i + CHUNK)
        part = [None if t is None else t[c] for t in draws]
        if torch.is_grad_enabled():
            outs.append(checkpoint(_render, models, rays[c], s, *part, use_reentrant=False))
        else:
            outs.append(_render(models, rays[c], s, *part))
    return {k: torch.cat([o[j] for o in outs]) for j, k in enumerate(KEYS)}


@torch.no_grad()
def render_image(models: Dict[str, NeRF], rays: torch.Tensor, s: Settings) -> Dict[str, torch.Tensor]:
    """A deterministic render (no perturbation, no noise) of rays (N, 8):
    ``rgb_fine`` and ``depth_fine``, in blocks of ``IMAGE_BLOCK`` rays."""
    s = dataclasses.replace(s, perturb=0.0, noise_std=0.0)
    rgb, depth = [], []
    for i in range(0, rays.shape[0], IMAGE_BLOCK):
        out = _render(models, rays[i : i + IMAGE_BLOCK], s, None, None, None, None)
        rgb.append(out[3])
        depth.append(out[4])
    return {"rgb_fine": torch.cat(rgb), "depth_fine": torch.cat(depth)}
