"""K2: inverse-CDF importance resampling merged with the coarse depths.

Counterpart of ``sinnerf_tpu/ops/fused_sample_pdf_t.py::
fused_sample_pdf_merge`` (:132), whose TPU kernel is ``_kernel`` (:61).  The
CUDA kernels are in ``csrc/fused_sample_pdf.cu``, whose source note gives the
bound (bytes: 1,280 B per ray at S = 64, K = 128, 1,792 B with ``u``) and the
design: ``sample_pdf_lanes_kernel`` on the path (LANES lanes per ray,
RAYS_PER_BLOCK rays per block, each output position by rank), and the first
port (one thread per ray, a serial two-pointer merge), kept on no path for
``chip_smoke.py``'s timing rounds (``launch_sample_pdf_merge_earlier``).
``sample_pdf_merge_plain`` is the plain PyTorch version.  It takes the CDF in
the kernels' sequential order (a loop over columns), not with
``torch.cumsum``: near ``denom ~ 1e-5`` an ulp of CDF error moves a fine
sample by up to ~1% of a bin.

The wrapper takes the plain version only for CPU tensors.  On CUDA tensors it
launches the kernel or raises, and adds one to
``fused_sample_pdf_merge.launches`` per launch.  The output carries no
gradient: the reference detaches the resampled depths.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from sinnerf_tpu_torch.core.sampling import f32_recip
from sinnerf_tpu_torch.ops import _build

SOURCE = "fused_sample_pdf.cu"
EPS = 1e-5  # reference models/rendering.py:33
# sample_pdf_lanes_kernel's split (csrc/fused_sample_pdf.cu; the wrapper holds
# the two together when it loads the kernel): lanes per ray (half a warp) and
# rays per block
LANES = 16
RAYS_PER_BLOCK = 16


def _round4(x: int) -> int:
    return (x + 3) // 4 * 4


def lanes_smem_bytes(s: int, k: int) -> int:
    """Shared memory of one block of ``sample_pdf_lanes_kernel``: per ray the
    z row, the bin edges, the w row (then the CDF) with four floats more, the
    fine depths and the output row, each rounded up to 16 bytes."""
    return RAYS_PER_BLOCK * (2 * _round4(s) + _round4(s) + 4 + _round4(k) + _round4(s + k)) * 4


def _check_inputs(z_vals, weights, n_importance, u, det) -> None:
    if z_vals.dim() != 2 or weights.shape != z_vals.shape:
        raise ValueError(f"z_vals and weights must both be (N, S), got {tuple(z_vals.shape)} and {tuple(weights.shape)}")
    if z_vals.shape[1] < 3:
        raise ValueError("resampling needs S >= 3 coarse samples")
    if n_importance < 1:
        raise ValueError("n_importance must be >= 1")
    if z_vals.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("z_vals and weights must be float32")
    if weights.device != z_vals.device:
        raise ValueError("z_vals and weights must be on one device")
    if not det:
        if u is None:
            raise ValueError("stochastic resampling requires u (N, n_importance)")
        if u.shape != (z_vals.shape[0], n_importance) or u.dtype != torch.float32 or u.device != z_vals.device:
            raise ValueError(f"u must be float32 (N, {n_importance}) on {z_vals.device}")


def _u_values(n: int, k: int, u: Optional[torch.Tensor], det: bool, device) -> torch.Tensor:
    # multiplies by float32 reciprocals, as XLA evaluates the TPU kernel's
    # divisions by constants and as the CUDA kernel does
    i = torch.arange(k, dtype=torch.float32, device=device)
    if det:  # linspace(0, 1, k); [0.] when k == 1
        return (i * f32_recip(max(k - 1, 1))).expand(n, k)
    return (i + u) * f32_recip(k)  # stratified sorted uniforms


def sample_pdf_merge_plain(
    z_vals: torch.Tensor,
    weights: torch.Tensor,
    n_importance: int,
    u: Optional[torch.Tensor] = None,
    det: bool = True,
) -> torch.Tensor:
    """Plain version: ``sort(cat(z, sample_pdf(mid(z), w[:, 1:-1], K)))``
    with the kernel's sequential sum and CDF."""
    n, s = z_vals.shape
    m = s - 2
    z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])  # (N, m+1) bin edges
    wm = weights[:, 1:-1] + EPS
    total = torch.zeros(n, dtype=torch.float32, device=z_vals.device)
    for j in range(m):
        total = total + wm[:, j]
    pdf = wm / total[:, None]
    cdf = torch.zeros((n, m + 1), dtype=torch.float32, device=z_vals.device)
    for j in range(m):
        cdf[:, j + 1] = cdf[:, j] + pdf[:, j]

    uu = _u_values(n, n_importance, u, det, z_vals.device).contiguous()
    cnt = torch.searchsorted(cdf, uu, right=True)
    below = torch.clamp(cnt - 1, min=0)
    above = torch.clamp(cnt, max=m)
    cdf_lo, cdf_hi = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    b_lo, b_hi = torch.gather(z_mid, 1, below), torch.gather(z_mid, 1, above)
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < EPS, torch.ones_like(denom), denom)
    z_fine = b_lo + (uu - cdf_lo) / denom * (b_hi - b_lo)
    return torch.sort(torch.cat([z_vals, z_fine], dim=-1), dim=-1).values


_signature_set = False


def _lib() -> ctypes.CDLL:
    """``csrc/fused_sample_pdf.cu``, its signatures set and the lanes
    kernel's split and shared memory held against this module's."""
    global _signature_set
    lib = _build.load(SOURCE)
    if not _signature_set:
        p, i = ctypes.c_void_p, ctypes.c_int
        for name in ("sample_pdf_lanes", "fused_sample_pdf_merge"):
            getattr(lib, name).argtypes = [p, p, p, p, i, i, i, i, p]
            getattr(lib, name).restype = i
        lib.sample_pdf_lanes_parts.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.sample_pdf_lanes_parts.restype = i
        lib.sample_pdf_lanes_layout.argtypes = [i]
        lib.sample_pdf_lanes_layout.restype = i
        lib.sample_pdf_lanes_smem_bytes.argtypes = [i, i]
        lib.sample_pdf_lanes_smem_bytes.restype = ctypes.c_longlong
        got = (lib.sample_pdf_lanes_layout(0), lib.sample_pdf_lanes_layout(1),
               lib.sample_pdf_lanes_smem_bytes(64, 128), lib.sample_pdf_lanes_smem_bytes(3, 1))
        want = (LANES, RAYS_PER_BLOCK, lanes_smem_bytes(64, 128), lanes_smem_bytes(3, 1))
        if got != want:
            raise RuntimeError(f"csrc/fused_sample_pdf.cu and ops/fused_sample_pdf.py disagree: {got} != {want}")
        _signature_set = True
    return lib


def _launch(entry: str, z_vals, weights, n_importance, u, det, *extra) -> torch.Tensor:
    """One launch of ``entry`` (a kernel of ``csrc/fused_sample_pdf.cu``, its
    ``extra`` int arguments before the stream) on CUDA tensors: (N, S + K)."""
    z = z_vals.contiguous()
    w = weights.contiguous()
    uc = None if det else u.contiguous()
    n, s = z.shape
    out = torch.empty((n, s + n_importance), dtype=torch.float32, device=z.device)
    lib = _lib()
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        rc = getattr(lib, entry)(
            z.data_ptr(), w.data_ptr(), None if uc is None else uc.data_ptr(), out.data_ptr(),
            n, s, n_importance, int(det), *extra, stream,
        )
    _build.check(lib, rc, entry)
    return out


@torch.no_grad()
def fused_sample_pdf_merge(
    z_vals: torch.Tensor,
    weights: torch.Tensor,
    n_importance: int,
    u: Optional[torch.Tensor] = None,
    det: bool = True,
) -> torch.Tensor:
    """z_vals (N, S) ascending coarse depths and their compositing weights ->
    (N, S + K) ascending: the coarse depths merged with K importance samples
    (det: ``u = linspace(0, 1, K)``; else ``u`` (N, K) uniforms in [0, 1)
    made stratified as ``(i + u_i) / K``)."""
    _check_inputs(z_vals, weights, n_importance, u, det)
    if z_vals.device.type == "cpu":
        return sample_pdf_merge_plain(z_vals, weights, n_importance, u, det)
    if z_vals.device.type != "cuda":
        raise ValueError(f"fused_sample_pdf_merge runs on cpu or cuda, not {z_vals.device}")
    out = _launch("sample_pdf_lanes", z_vals, weights, n_importance, u, det)
    fused_sample_pdf_merge.launches += 1
    return out


fused_sample_pdf_merge.launches = 0


@torch.no_grad()
def launch_sample_pdf_merge_earlier(
    z_vals: torch.Tensor,
    weights: torch.Tensor,
    n_importance: int,
    u: Optional[torch.Tensor] = None,
    det: bool = True,
) -> torch.Tensor:
    """The first port of K2 (one thread per ray, ``sample_pdf_merge_kernel``)
    on CUDA tensors, the same function.  Off every path: ``chip_smoke.py``
    times it beside the kernel on the path and holds it against the plain
    version."""
    _check_inputs(z_vals, weights, n_importance, u, det)
    if z_vals.device.type != "cuda":
        raise ValueError(f"launch_sample_pdf_merge_earlier runs on cuda tensors, not {z_vals.device}")
    out = _launch("fused_sample_pdf_merge", z_vals, weights, n_importance, u, det)
    launch_sample_pdf_merge_earlier.launches += 1
    return out


launch_sample_pdf_merge_earlier.launches = 0


PARTS = {"rows": 1, "cdf": 2}  # sample_pdf_lanes_parts' cuts


def launch_sample_pdf_merge_parts(part: str, z_vals, weights, n_importance, u=None, det=True) -> torch.Tensor:
    """The kernel on the path cut after its rows (``rows``: loads, bin edges,
    the store of an unwritten output row) or after its CDF (``cdf``), for
    timing only: the rows it returns are not the result.  Off every path and
    counted by no launch count."""
    _check_inputs(z_vals, weights, n_importance, u, det)
    if part not in PARTS or z_vals.device.type != "cuda":
        raise ValueError(f"launch_sample_pdf_merge_parts times the kernel's cuts {sorted(PARTS)} on cuda tensors")
    return _launch("sample_pdf_lanes_parts", z_vals, weights, n_importance, u, det, PARTS[part])
