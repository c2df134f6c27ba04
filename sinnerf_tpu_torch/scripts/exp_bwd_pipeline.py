"""X2: the pipelining experiments on K3-bwd, and the experiment that times them.

Counterpart of the JAX package's ``scripts/exp_bwd_pipeline.py``:
``run_variant`` (:326) with its kernel ``_exp_bwd_kernel`` (:73-323, call
:369).  The CUDA kernel is ``csrc/exp_bwd_pipeline.cu``, one template over
the earlier K3-bwd's body (``csrc/train_backward.cuh``); its note says
what each variant changes.  bfloat16, no noise, a black background and the
new activation only, as JAX's.

    python -m sinnerf_tpu_torch.scripts.exp_bwd_pipeline [--n_rays 16384] [--n_samples 192] [--variants SPEC]

runs the experiment on the card: the production K3-bwd (the anchor) and
every ``variant:rays:streams`` entry of SPEC at 16,384 rays x 192 samples,
timed with CUDA events after a warm-up in rounds that alternate them all,
each beside ``base`` in the same round (mean and range of the ratio).  The
variants share the earlier K3-bwd body (``train_backward.cuh``, ``wmma``):
``base`` is that kernel, and production over ``base`` is the Hopper K3-bwd
(``fused_render_train_sm90.cu``) over the earlier one.  The inputs' residuals
come from the earlier forward (``launch_train_fwd_wmma``), so that the
variants' recompute rounds as their forward did; the exact variants'
gradients are held against ``base``'s.  SPEC's middle field is the port's tile, rays per
block: JAX's ``r_tile`` 512 and 1024 are 32 and 64 rays (``R_TILE``).  The
default is JAX's (:445) in those terms.

``base``, ``two_stream`` and ``pe_pipe`` compute the production gradient;
``no_db``, ``no_mask``, ``no_dw``, ``mxu_floor`` and ``cheap_pe`` compute
other gradients on purpose (timing probes).  Each has a plain version:
``render_level_train_backward_plain`` for the exact ones, ``ablation_plain``
for the others.  JAX's ``half = n_samples // n_streams`` drops the last
sample when S is odd; the port raises.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import functools
import sys
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sinnerf_tpu_torch.core.composite import intervals
from sinnerf_tpu_torch.core.encoding import positional_encoding_recurrence
from sinnerf_tpu_torch.models.nerf import nerf_from_state, random_params, state_dict_from_jax
from sinnerf_tpu_torch.ops import _build
from sinnerf_tpu_torch.ops import fused_render_train as frt
from sinnerf_tpu_torch.ops.fused_mlp import (
    BIAS_SIZE,
    HALF,
    N_FREQS_DIR,
    N_FREQS_XYZ,
    WEIGHT_SIZE,
    XYZ_CH,
    XYZ_PAD,
    PackedWeights,
    _chunks,
    mlp_backward_plain,
    mlp_plain,
    pack_grads,
    pack_weights,
    unpack_grads,
    weight_views,
)
from sinnerf_tpu_torch.scripts import PEAK_BF16, ratios
from sinnerf_tpu_torch.utils.device import resolve_device
from sinnerf_tpu_torch.utils.timing import interleaved_ms

SOURCE = "exp_bwd_pipeline.cu"
VARIANTS = ("base", "no_db", "no_mask", "no_dw", "mxu_floor", "cheap_pe", "two_stream", "pe_pipe")
EXACT = ("base", "two_stream", "pe_pipe")
# the kernel's variant ids: two_stream is base at two samples per tile
VARIANT_IDS = {"base": 0, "two_stream": 0, "no_db": 1, "no_mask": 2, "no_dw": 3, "mxu_floor": 4, "cheap_pe": 5,
               "pe_pipe": 6}
# (variant id, rays per block, samples of a ray per MLP tile) the source builds
BUILT = {(0, 64, 1), (0, 32, 2), (0, 64, 2)} | {(i, 64, 1) for i in range(1, 7)}
R_TILE = {512: 32, 1024: 64}  # JAX's r_tile (rays per grid step) -> the port's rays per block
DEFAULT_SPEC = "base:64:1,no_db:64:1,no_mask:64:1,no_dw:64:1,mxu_floor:64:1,two_stream:32:2,two_stream:64:2"
ALL_SPEC = DEFAULT_SPEC + ",cheap_pe:64:1,pe_pipe:64:1"
N_RAYS, N_SAMPLES = 16384, 192
ROUNDS, REPS = 6, 2  # rounds that alternate production and the variants; launches of each per round
BASE = "base:64:1"  # what every variant is timed against, in the same round
# multiply-adds per point: recompute, dgrad (no gradient to x or the
# direction PE) and wgrad (the direction-PE block once per ray); no_dw
# drops the wgrad
MAC_RECOMPUTE, MAC_DGRAD, MAC_WGRAD = 593_408, 556_544, 589_312
# the exact variants against ``base`` (the earlier K3-bwd, whose body they
# share), worst leaf (largest
# difference over the leaf's largest entry, relative L2): the same function,
# its f32 dW/db summed in another order (two_stream's 128-point tiles, the
# atomics' order from run to run).  Set from K3-bwd's own readings on an
# H100: at 16,384 x 192 two_stream reads up to 1.6e-5 / 6.1e-6 and
# production's own two runs 3.3e-6 / 1.6e-6, the limit about three times the
# first; at 128 rays x 8 and 333 x 10 (EXACT_TOL_SMALL, fewer terms in each
# sum) the exact variants read up to 5.3e-7 / 2.5e-7 and production's two
# runs 2.9e-7 / 1.4e-7, the limit about four times the first
EXACT_TOL = (5e-5, 2e-5)
EXACT_TOL_SMALL = (2e-6, 1e-6)


class BwdInputs(NamedTuple):
    """The backward's inputs, the production wrapper's layouts: packed bf16
    weights, rays (N, 6), ascending z (N, S), the forward's residuals weights
    and alphas (N, S) and rgb_s (N, S, 3), the cotangents g_rgb (N, 3),
    g_depth (N,), g_w (N, S); all float32.  X2 takes no noise and a black
    background only (``run_variant`` raises on anything else)."""

    packed: PackedWeights
    rays6: torch.Tensor
    z: torch.Tensor
    weights: torch.Tensor
    alphas: torch.Tensor
    rgb_s: torch.Tensor
    g_rgb: torch.Tensor
    g_depth: torch.Tensor
    g_w: torch.Tensor
    noise: Optional[torch.Tensor] = None
    white_back: bool = False


def _mlp_backward_no_mask(packed, kept, g_rgb, g_sigma):
    """``mlp_backward_plain`` without the trunk's ReLU masks (h1..h8): the
    ``no_mask`` and ``mxu_floor`` ablations.  Returns (grads, da_d)."""
    v = weight_views(packed)
    cd = kept["x"].dtype
    grads: Dict[str, torch.Tensor] = {}

    def emit(wname, bname, delta, layer_in):
        grads[wname] = delta.float().T @ layer_in.float()
        if bname is not None:
            grads[bname] = delta.float().sum(0)

    def back(delta, wname):
        return delta.float() @ v[wname].float()

    tt = torch.tanh(0.5 * kept["a_rgb"])
    da_rgb = (g_rgb * (0.2505 * (1.0 - tt * tt))).to(cd)
    emit("wrgb", "brgb", da_rgb, kept["d"])
    da_d = (back(da_rgb, "wrgb") * torch.sigmoid(kept["a_d"] - 1.0)).to(cd)
    emit("wdh", "bd", da_d, kept["f"])
    df = back(da_d, "wdh").to(cd)
    emit("wfin", "bfin", df, kept["h8"])
    g_sig = g_sigma.to(cd)[:, None]
    emit("wsig", "bsig", g_sig, kept["h8"])
    dh = back(df, "wfin") + back(g_sig, "wsig")
    for i in range(8, 0, -1):
        da = dh.to(cd)
        if i == 1:
            emit("w1", "b1", da, kept["x"])
        elif i == 5:
            emit("w5h", "b5", da, kept["h4"])
            emit("w5x", None, da, kept["x"])
            dh = back(da, "w5h")
        else:
            emit(f"w{i}", f"b{i}", da, kept[f"h{i - 1}"])
            dh = back(da, f"w{i}")
    return grads, da_d


@torch.no_grad()
def ablation_plain(variant: str, inputs: BwdInputs, chunk: int = frt.PLAIN_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of an ablation (``no_db``, ``no_mask``, ``no_dw``,
    ``mxu_floor``, ``cheap_pe``): the production plain backward's steps with
    the part removed that JAX's ``_exp_bwd_kernel`` removes (:161-200), from
    ``mlp_plain``'s kept activations.  Returns the packed float32 (dw, db):
    a block an ablation drops is zero, ``wdx`` is always summed."""
    if variant not in VARIANTS or variant in EXACT:
        raise ValueError(f"{variant!r} is no ablation of X2: {tuple(v for v in VARIANTS if v not in EXACT)}")
    packed = inputs.packed
    cd = packed.w.dtype
    dw = torch.zeros(WEIGHT_SIZE, dtype=torch.float32, device=inputs.z.device)
    db = torch.zeros(BIAS_SIZE, dtype=torch.float32, device=inputs.z.device)
    for c in _chunks(inputs.z.shape[0], chunk):
        rays6, z = inputs.rays6[c], inputs.z[c]
        n, s = z.shape
        da_alpha = frt.composite_adjoint(z, inputs.weights[c], inputs.alphas[c], inputs.rgb_s[c], inputs.g_rgb[c],
                                         inputs.g_depth[c], inputs.g_w[c])
        o, d = rays6[:, 0:3], rays6[:, 3:6]
        if variant == "mxu_floor":  # the constant 0.01 in every column, the pad column too
            x = torch.full((n * s, XYZ_PAD), 0.01, dtype=torch.float32, device=z.device)
        elif variant == "cheap_pe":  # bf16(z 0.01) in every column
            x = (z.reshape(-1, 1) * 0.01).expand(n * s, XYZ_PAD)
        else:
            x = positional_encoding_recurrence(o[:, None, :] + d[:, None, :] * z[..., None], N_FREQS_XYZ)
            x = torch.nn.functional.pad(x.reshape(n * s, XYZ_CH), (0, XYZ_PAD - XYZ_CH))
        d_pe = positional_encoding_recurrence(d, N_FREQS_DIR)
        d_pe = d_pe[:, None, :].expand(n, s, d_pe.shape[-1]).reshape(n * s, -1)
        kept: Dict[str, torch.Tensor] = {}
        mlp_plain(packed, x[:, :XYZ_CH], d_pe, True, keep=kept)
        kept["x"] = x.to(cd)  # the layer-1 input with its 64th column (the weights' pad column is zero)
        dsig = da_alpha * (1.0 - inputs.alphas[c]) * intervals(z, d)
        dsig = torch.where(kept["sigma"].view(n, s) > 0, dsig, torch.zeros_like(dsig))
        g_rgb_s = (inputs.weights[c][..., None] * inputs.g_rgb[c][:, None, :]).reshape(n * s, 3)
        if variant in ("no_mask", "mxu_floor"):
            grads, da_d = _mlp_backward_no_mask(packed, kept, g_rgb_s, dsig.reshape(n * s))
        else:
            grads, da_d = mlp_backward_plain(packed, kept, g_rgb_s, dsig.reshape(n * s))
        grads["wdx"] = da_d.float().view(n, s, HALF).sum(1).T @ kept["d_in"].view(n, s, -1)[:, 0].float()
        if variant == "no_dw":
            grads = {k: (g if k == "wdx" or k.startswith("b") else torch.zeros_like(g)) for k, g in grads.items()}
        if variant in ("no_db", "mxu_floor"):
            grads = {k: (torch.zeros_like(g) if k.startswith("b") else g) for k, g in grads.items()}
        cw, cb = pack_grads(grads)
        dw += cw
        db += cb
    return dw, db


def variant_plain(variant: str, inputs: BwdInputs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of any variant: the packed float32 (dw, db)."""
    if variant in EXACT:
        i = inputs
        return frt.render_level_train_backward_plain(i.packed, i.rays6, i.z, None, i.weights, i.alphas, i.rgb_s,
                                                     i.g_rgb, i.g_depth, i.g_w, True, False)
    return ablation_plain(variant, inputs)


_signature_set = False


def _lib() -> ctypes.CDLL:
    global _signature_set
    lib = _build.load(SOURCE)
    if not _signature_set:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.exp_bwd_pipeline_scratch_bytes.argtypes = [i] * 3
        lib.exp_bwd_pipeline_scratch_bytes.restype = ctypes.c_longlong
        lib.exp_bwd_pipeline.argtypes = [i] * 3 + [p] * 14 + [i] * 4 + [p]
        lib.exp_bwd_pipeline.restype = i
        lib.nerf_packed_weight_size.argtypes = []
        lib.nerf_packed_weight_size.restype = i
        if lib.nerf_packed_weight_size() != WEIGHT_SIZE:
            raise RuntimeError("csrc/nerf_mlp.cuh and ops/fused_mlp.py disagree on the weight layout")
        _signature_set = True
    return lib


def _check(variant: str, r_tile: int, n_streams: int, inputs: BwdInputs) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown X2 variant {variant!r}: {VARIANTS}")
    if (VARIANT_IDS[variant], r_tile, n_streams) not in BUILT or (variant == "two_stream") != (n_streams > 1):
        raise ValueError(f"{variant}:{r_tile}:{n_streams} is not built: base and the ablations run 64 rays x 1 "
                         f"sample per tile, two_stream 32 or 64 rays x 2 samples")
    i = inputs
    n, s = i.z.shape
    if s % n_streams:
        raise ValueError(f"{n_streams} streams need a sample count that they divide, got S = {s}")
    if i.noise is not None or i.white_back:
        raise ValueError("X2 takes no sigma noise and a black background only, as JAX's experiment")
    if i.packed.w.dtype != torch.bfloat16:
        raise ValueError("X2 runs in bfloat16 only: pack the weights with torch.bfloat16")
    shapes = dict(rays6=(n, 6), z=(n, s), weights=(n, s), alphas=(n, s), rgb_s=(n, s, 3), g_rgb=(n, 3), g_depth=(n,),
                  g_w=(n, s))
    for name, shape in shapes.items():
        t = getattr(i, name)
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {shape}, got {tuple(t.shape)} {t.dtype}")
        if t.device != i.packed.w.device:
            raise ValueError(f"{name} ({t.device}) and the weights ({i.packed.w.device}) must be on one device")
    if i.z.device.type not in ("cpu", "cuda"):
        raise ValueError(f"X2 runs on cpu or cuda, not {i.z.device}")


def launch_variant(variant: str, r_tile: int, n_streams: int, inputs: BwdInputs) -> Tuple[torch.Tensor, torch.Tensor]:
    """One variant on CUDA tensors: zeroed, then summed, packed float32
    (dw, db).  Adds one to ``launch_variant.launches[tag]`` per launch, tag
    ``variant:r_tile:n_streams``."""
    i = inputs
    n, s = i.z.shape
    dev = i.z.device
    lib = _lib()
    vid = VARIANT_IDS[variant]
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count * (2 if r_tile * n_streams == 64 else 1)
    scratch = torch.empty(blocks * lib.exp_bwd_pipeline_scratch_bytes(vid, r_tile, n_streams), dtype=torch.uint8,
                          device=dev)
    dsig_part = torch.empty((n, s), dtype=torch.float32, device=dev)
    dw = torch.zeros(WEIGHT_SIZE, dtype=torch.float32, device=dev)
    db = torch.zeros(BIAS_SIZE, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.exp_bwd_pipeline(
            vid, r_tile, n_streams, i.rays6.data_ptr(), i.z.data_ptr(), i.packed.w.data_ptr(), i.packed.b.data_ptr(),
            i.weights.data_ptr(), i.alphas.data_ptr(), i.rgb_s.data_ptr(), i.g_rgb.data_ptr(), i.g_depth.data_ptr(),
            i.g_w.data_ptr(), dsig_part.data_ptr(), scratch.data_ptr(), dw.data_ptr(), db.data_ptr(), n, s, blocks, 1,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, rc, f"exp_bwd_pipeline {variant}:{r_tile}:{n_streams}")
    launch_variant.launches[f"{variant}:{r_tile}:{n_streams}"] += 1
    return dw, db


launch_variant.launches = collections.Counter()


def run_variant(variant: str, r_tile: int, n_streams: int, inputs: BwdInputs) -> Tuple[torch.Tensor, torch.Tensor]:
    """One variant of X2 (JAX ``run_variant``; ``r_tile`` in rays per block):
    the packed float32 (dw, db) of every weight block and bias.  On CUDA
    tensors it launches the kernel or raises; on CPU tensors it runs
    ``variant_plain``."""
    _check(variant, r_tile, n_streams, inputs)
    if inputs.z.device.type == "cuda":
        return launch_variant(variant, r_tile, n_streams, inputs)
    return variant_plain(variant, inputs)


def parse_spec(spec: str):
    """``variant:rays:streams,...`` -> [(variant, rays, streams)]."""
    out = []
    for entry in spec.split(","):
        variant, rays, streams = entry.split(":")
        out.append((variant, int(rays), int(streams)))
    return out


def bound_ms(variant: str, n: int, s: int) -> float:
    """The least time of a variant: its multiply-adds at the bf16 dense peak
    (the bytes take a few hundredths of it)."""
    mac = MAC_RECOMPUTE + MAC_DGRAD + (0 if variant == "no_dw" else MAC_WGRAD)
    return 2.0 * mac * n * s / PEAK_BF16 * 1e3


def leaf_errors(got, want) -> Tuple[float, float]:
    """Worst parameter leaf of two packed gradients: (largest difference over
    the leaf's largest entry, relative L2)."""
    worst_max = worst_l2 = 0.0
    for g, w in zip(unpack_grads(*got), unpack_grads(*want)):
        diff = g.double() - w.double()
        worst_max = max(worst_max, (diff.abs().max() / (w.abs().max().double() + 1e-30)).item())
        worst_l2 = max(worst_l2, (diff.norm() / (w.double().norm() + 1e-30)).item())
    return worst_max, worst_l2


def make_inputs(n_rays: int, n_samples: int, seed: int, device) -> BwdInputs:
    """JAX ``main``'s inputs (:402-417) from a numpy seed: random weights,
    rays with o ~ 0.1 N(0, 1) and d ~ N(0, 1), sorted uniform depths in
    [2, 6], the residuals of the earlier forward kernel, whose body the
    variants recompute with (``launch_train_fwd_wmma`` on the card, the plain
    version on the CPU) and normal cotangents (g_w x 0.01)."""
    rng = np.random.default_rng(seed)
    packed = pack_weights(nerf_from_state(state_dict_from_jax(random_params(rng))).to(device), torch.bfloat16)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    rays6 = t(np.concatenate([rng.normal(size=(n_rays, 3)) * 0.1, rng.normal(size=(n_rays, 3))], axis=1))
    z = t(np.sort(rng.uniform(2.0, 6.0, size=(n_rays, n_samples)), axis=1))
    if device.type == "cuda":
        _, _, weights, alphas, rgb_s = frt.launch_train_fwd_wmma(packed, rays6, z, None, True, False)
    else:
        _, _, weights, alphas, rgb_s = frt.render_level_train_forward_plain(packed, rays6, z, None, True, False)
    g_rgb, g_depth = t(rng.normal(size=(n_rays, 3))), t(rng.normal(size=(n_rays,)))
    g_w = t(rng.normal(size=(n_rays, n_samples)) * 0.01)
    return BwdInputs(packed, rays6, z, weights, alphas, rgb_s, g_rgb, g_depth, g_w)


def main(argv: Optional[list] = None, inputs: Optional[BwdInputs] = None) -> dict:
    """The experiment on the card, on ``inputs`` (``make_inputs`` at the
    flags' size by default): production K3-bwd's time and run-to-run spread,
    and per entry of ``--variants`` its ms, share of the bound, ratio to
    production and to ``base`` and, for the exact variants, the error
    against ``base`` (or why it failed)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_rays", type=int, default=N_RAYS)
    ap.add_argument("--n_samples", type=int, default=N_SAMPLES)
    ap.add_argument("--variants", default=DEFAULT_SPEC, help="variant:rays_per_block:streams,... (all: " + ALL_SPEC + ")")
    args = ap.parse_args(argv)
    device = resolve_device("cuda")  # it times kernels: on the card or not at all
    i = inputs if inputs is not None else make_inputs(args.n_rays, args.n_samples, 0, device)
    n, s = i.z.shape
    prod_args = (i.packed, i.rays6, i.z, None, i.weights, i.alphas, i.rgb_s, i.g_rgb, i.g_depth, i.g_w, True, False)
    prod = frt.launch_train_bwd(*prod_args)
    spread = leaf_errors(frt.launch_train_bwd(*prod_args), prod)
    fns = {"production": functools.partial(frt.launch_train_bwd, *prod_args)}
    results, grads = {}, {}
    for variant, rays, streams in parse_spec(args.variants):
        tag = f"{variant}:{rays}:{streams}"
        try:
            grads[tag] = run_variant(variant, rays, streams, i)  # the warm-up, and the gradient held
            torch.cuda.synchronize()
            fns[tag] = functools.partial(run_variant, variant, rays, streams, i)
        except Exception as e:  # noqa: BLE001 -- the experiment goes on, as JAX's does
            results[tag] = dict(failed=f"{type(e).__name__}: {e}")
            print(f"{tag:18s} FAILED: {type(e).__name__}: {str(e)[:200]}", flush=True)
    per_round = interleaved_ms(fns, ROUNDS, REPS)
    ref = BASE if BASE in fns else "production"
    vs_prod, vs_ref = ratios(per_round, "production"), ratios(per_round, ref)
    prod_ms = sum(per_round["production"]) / ROUNDS
    bound = bound_ms("base", n, s)
    results["production"] = dict(ms=prod_ms, bound_ms=bound, run_to_run=spread, rounds_ms=per_round["production"],
                                 vs_base=sum(vs_ref["production"]) / ROUNDS,
                                 vs_base_range=(min(vs_ref["production"]), max(vs_ref["production"])))
    print(f"{torch.cuda.get_device_name(0)}; {n} rays x {s} samples; production K3-bwd {prod_ms:.3f} ms "
          f"({100 * bound / prod_ms:.1f}% of its {bound:.3f} ms bound), two runs differ by {spread[0]:.2e} / "
          f"{spread[1]:.2e}; {ROUNDS} rounds x {REPS} launches each; production over {ref} per round "
          f"{min(vs_ref['production']):.4f}-{max(vs_ref['production']):.4f}", flush=True)
    base = grads[BASE] if BASE in grads else run_variant("base", 64, 1, i)
    for tag, got in grads.items():
        variant = tag.split(":")[0]
        ms = sum(per_round[tag]) / ROUNDS
        b = bound_ms(variant, n, s)
        r = dict(ms=ms, rounds_ms=per_round[tag], bound_ms=b, bound_share=b / ms,
                 vs_production=sum(vs_prod[tag]) / ROUNDS, vs_base=sum(vs_ref[tag]) / ROUNDS,
                 vs_base_range=(min(vs_ref[tag]), max(vs_ref[tag])),
                 finite=bool(got[0].isfinite().all() and got[1].isfinite().all()))
        line = (f"{tag:18s} {ms:9.3f} ms {100 * b / ms:5.1f}% of bound {r['vs_production']:6.3f} x production "
                f"{r['vs_base']:6.4f} x {ref} ({r['vs_base_range'][0]:.4f}-{r['vs_base_range'][1]:.4f})")
        if variant in EXACT:
            r["err_vs_base"] = err = leaf_errors(got, base)
            r["exact_tol"] = EXACT_TOL
            r["exact_ok"] = err[0] <= EXACT_TOL[0] and err[1] <= EXACT_TOL[1]
            line += f"   vs base {err[0]:.2e} / {err[1]:.2e} (tol {EXACT_TOL[0]:.0e} / {EXACT_TOL[1]:.0e})"
            if not r["exact_ok"]:
                line += " DIVERGED"
        results[tag] = r
        print(line, flush=True)
    return results


if __name__ == "__main__":
    res = main()
    sys.exit(0 if all("failed" not in r and r.get("exact_ok", True) for r in res.values()) else 1)
