"""Sinusoidal positional encoding.

Counterpart of ``sinnerf_tpu/core/encoding.py`` (reference
``models/nerf.py:7-41``).  Both functions here emit the reference's
interleaved channel order ``[x, sin(f0 x), cos(f0 x), sin(f1 x), ...]``,
each block spanning all input channels; the port feeds the reference-layout
weights directly and needs no ``blocked_perm``.
"""

from __future__ import annotations

import torch

# Exact sin/cos every PE_RESTART doublings bounds the double-angle
# recurrence error to ~1e-5 (sinnerf_tpu/ops/fused_mlp_t.py:57).
PE_RESTART = 4


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


def positional_encoding_recurrence(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """Power-of-two PE by the double-angle recurrence, in the interleaved
    order: exact ``sin/cos(2^k x)`` when ``k % PE_RESTART == 0``, else
    ``s' = 2 s c``, ``c' = 1 - 2 s s`` (JAX ``fused_mlp_t._pe_fwd``,
    ``fused_mlp_t.py:135-147``).  Evaluated in float32; this is what the
    fused render kernel and its plain version compute."""
    x = x.float()
    parts = [x]
    s = c = None
    for k in range(n_freqs):
        if k % PE_RESTART == 0:
            xk = x * (2.0**k)
            s, c = torch.sin(xk), torch.cos(xk)
        else:
            s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
        parts += [s, c]
    return torch.cat(parts, dim=-1)
