"""Sinusoidal positional encoding.

Counterpart of ``sinnerf_tpu/core/encoding.py`` (reference
``models/nerf.py:7-41``).  Both functions here emit the reference's
interleaved channel order ``[x, sin(f0 x), cos(f0 x), sin(f1 x), ...]``,
each block spanning all input channels.  The reference keeps the exact
sin/cos only.
"""

from __future__ import annotations

import torch

def freq_bands(n_freqs: int, logscale: bool = True, device=None) -> torch.Tensor:
    if logscale:
        return 2.0 ** torch.arange(n_freqs, dtype=torch.float32, device=device)
    return torch.linspace(
        1.0, 2.0 ** (n_freqs - 1), n_freqs, dtype=torch.float32, device=device
    )


def positional_encoding(
    x: torch.Tensor, n_freqs: int, logscale: bool = True
) -> torch.Tensor:
    """Embed ``x`` (..., C) to (..., C * (2 * n_freqs + 1)) with exact
    sin/cos (JAX ``positional_encoding``, ``encoding.py:23``)."""
    bands = freq_bands(n_freqs, logscale, x.device).to(x.dtype)
    xb = x[..., None, :] * bands[:, None]  # (..., F, C)
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)  # (..., F, 2, C)
    enc = enc.reshape(*x.shape[:-1], n_freqs * 2 * x.shape[-1])
    return torch.cat([x, enc], dim=-1)
