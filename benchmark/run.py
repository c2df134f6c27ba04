"""Run one cell of the benchmark of ``sinnerf_tpu_torch`` and print its
result as the last line of standard output:

    python3 -m benchmark.run --workload llff_room.step1 --seed 7 --seconds 35 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a ``torch.profiler`` trace of the window.  The run
needs as many CUDA cards as the cell asks for and fails without them.  It
writes nothing outside ``TMPDIR`` (the scene, the trainer's logs) and the
checkout (the kernels' build in ``build/``).  After the window it checks
what the window produced against the plain reference (``correct``), prints
each number compared beside its limit as the last lines of standard error
and under ``check`` in the result, and fails if the process holds a module
of JAX or of the JAX package.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up starts here, before torch is imported

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

from benchmark import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sinnerf_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """The modules loaded whose whole top-level name is JAX's, JAX's
    libraries' or the JAX package's (``sinnerf_tpu_torch`` is none of them)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def _environment(root: str) -> None:
    """Fixed cache directories inside the checkout; no JAX behind a library."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(root, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(root, "build", "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def _leg(cell: spec.Cell):
    kind = cell.traffic["leg"]
    if kind == "train":
        from benchmark.train_leg import TrainLeg
        return TrainLeg
    if kind == "eval":
        from benchmark.eval_leg import EvalLeg
        return EvalLeg
    raise ValueError(f"unknown leg {kind!r} in traffic of {cell.name}")


def _finite(x: Optional[float]) -> Optional[float]:
    return x if x is not None and math.isfinite(x) else None


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
             extra_flags=(), fault=None, t0: float = None) -> Dict[str, Any]:
    """Set up, warm up, measure and check one run of ``cell``; the result's
    keys are the result line's.  ``fault`` (tests) breaks the timed path:
    ``fault(leg)`` is called once the leg is built."""
    import torch

    from benchmark import judge, trace
    from benchmark.train_leg import run_in_tmp

    t0 = T0 if t0 is None else t0
    cuda = device == "cuda"

    def body(work: str) -> Dict[str, Any]:
        leg = _leg(cell)(cell, seed, device, work, extra_flags)
        if fault is not None:
            fault(leg)
        leg.warm_up()
        setup_s = time.perf_counter() - t0
        spans = trace.Spans(traced)
        prof = None
        if traced:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            with profile(activities=activities) as prof:
                w = leg.window(seconds, spans)
        else:
            w = leg.window(seconds, spans)
        peak = torch.cuda.max_memory_allocated(leg.device) if cuda else 0
        device_info: Dict[str, Any] = {"platform": "gpu" if cuda else "cpu",
                                       "kind": torch.cuda.get_device_name(leg.device) if cuda else "cpu",
                                       "count": cell.chips, "memory_peak_bytes": peak}
        metrics: Dict[str, Dict[str, Any]] = {}
        breakdown = None
        units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
        if not traced:
            values = {"setup_s": setup_s, **leg.end_to_end(w)}
            for m in cell.end_to_end:
                if _finite(values.get(m["name"])) is not None:
                    metrics[m["name"]] = {"value": values[m["name"]], "unit": units[m["name"]]}
        else:
            tr = trace.read(prof)
            lo_hi = trace.window(tr)
            ctx = types.SimpleNamespace(cell=cell, counters=leg.counters(), window=w, spans=spans, trace=tr,
                                        lo=lo_hi[0] if lo_hi else None, hi=lo_hi[1] if lo_hi else None)
            for m in cell.per_layer:
                value = spec.reader(m["name"])(ctx)
                if _finite(value) is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            if lo_hi:
                device_info["busy_s"] = trace.busy_seconds(tr, *lo_hi)
                device_info["window_s"] = (lo_hi[1] - lo_hi[0]) * 1e-9
                breakdown = {"device_ops": trace.device_ops(tr, *lo_hi), "idle_gaps": trace.idle_gaps(tr, *lo_hi)}
            prof = tr = ctx = None
        attempted = w.get("steps", w.get("images"))
        prog = leg.free()
        t_check = time.perf_counter()
        ref = leg.reference()
        numbers = leg.numbers(prog, ref)
        correct = judge.verdict(numbers, cell.limits) and w["failed"] == 0
        result = {"correct": correct, "attempted": attempted, "failed": w["failed"], "metrics": metrics,
                  "device": device_info}
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["check"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                           for k, v in judge.lines(numbers, cell.limits).items()}
        result["_info"] = {"setup_s": setup_s, "check_s": time.perf_counter() - t_check, "window": {
            k: v for k, v in w.items() if k not in ("rays", "step_ms")}}
        return result

    return run_in_tmp(body)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _environment(spec.ROOT)
    cell = spec.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {count}", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    info = result.pop("_info")
    found = forbidden_modules()
    if found:
        print(f"the process holds modules of JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    print(f"setup_s {info['setup_s']:.3f}  check_s {info['check_s']:.3f}  window {json.dumps(info['window'])}",
          file=sys.stderr)
    for name, v in result["check"].items():
        print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
