"""The program's own spans and the host's CUDA calls in a traced run.

The port marks its train path's phases while a profiler runs
(``sinnerf_tpu_torch/utils/spans.py``: ``record_function("sinnerf.<name>")``,
all opened on the trainer's thread).  ``read`` keeps those marks, with the
thread that opened them, and the host's CUDA API calls (``cuda*``, ``cu*``)
that launch work on the card or wait for it.  ``phase_idle`` puts each idle
gap of the card down to the innermost program span open on the trainer's
thread when the gap began, as ``trace.idle_gaps`` does with the benchmark's
spans; ``phase_launches`` and ``phase_waits`` count the calls that start
inside each span, from any thread (the backward's launches come from
autograd's own thread while the trainer's waits in ``step.backward``).

``trace.read`` keeps neither, and ``run.py`` hands the readers of
``benchmark/metrics`` only its ``Trace``; it holds the finished profile in a
local while they run, and ``of(ctx)`` reads the program's part from there,
once per run.  A run without the program's marks (a program that has no
spans) or on no card reads as None.

    python3 -m benchmark.program --workload lego.step2 --seed 7 --seconds 51

is ``benchmark.run --trace 1`` that also prints the phase table (idle
seconds, launches and waits by span) on standard error.
"""

from __future__ import annotations

import dataclasses
import sys
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from benchmark import trace

PREFIX = "sinnerf."
LAUNCHES = ("cudaLaunch", "cuLaunch")
WAITS = frozenset({"cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize", "cudaMemcpy"})
STEP = "step"


@dataclasses.dataclass
class Program:
    marks: List[Tuple[str, int, int, int]]  # the program's spans: (name without "sinnerf.", thread, start ns, end ns)
    calls: List[Tuple[str, int, int, int]]  # the host's launches and waits: (name, thread, start ns, end ns)


def is_launch(name: str) -> bool:
    return name.startswith(LAUNCHES)


def is_wait(name: str) -> bool:
    return name in WAITS


def read(prof) -> Program:
    """The program's marks and the host's launch and wait calls of a
    finished ``torch.profiler.profile``."""
    marks, calls = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:  # the marks' copies on the card's timeline too
            continue
        name = e.name()
        if name.startswith(PREFIX):
            out, name = marks, name[len(PREFIX):]
        elif is_launch(name) or is_wait(name):
            out = calls
        else:
            continue
        start = trace._ns(e, "start")
        end = start + (int(e.duration_ns()) if hasattr(e, "duration_ns") else int(e.duration_us() * 1000))
        out.append((name, int(e.start_thread_id()), start, end))
    return Program(marks=marks, calls=calls)


def trainer_marks(program: Program) -> List[Tuple[str, int, int, int]]:
    """The marks of the thread that opens the ``step`` spans."""
    threads = Counter(t for n, t, _, _ in program.marks if n == STEP)
    if not threads:
        return []
    thread = threads.most_common(1)[0][0]
    return [m for m in program.marks if m[1] == thread]


def _innermost(marks: Sequence[Tuple[str, int, int, int]], times: Sequence[int]) -> List[str]:
    """For each of the ascending ``times``, the name of the innermost of
    ``marks`` (one thread's, so they nest) open at it, or "outside"."""
    ordered = sorted(marks, key=lambda m: (m[2], -m[3]))
    stack: List[Tuple[str, int, int, int]] = []
    out, i = [], 0
    for t in times:
        while i < len(ordered) and ordered[i][2] <= t:
            while stack and stack[-1][3] <= ordered[i][2]:
                stack.pop()
            stack.append(ordered[i])
            i += 1
        while stack and stack[-1][3] <= t:
            stack.pop()
        out.append(stack[-1][0] if stack else "outside")
    return out


def phase_idle(tr: trace.Trace, program: Program, lo: int, hi: int) -> Dict[str, float]:
    """The card's idle seconds in [lo, hi], each gap credited to the
    innermost program span open on the trainer's thread when it began."""
    gaps, t = [], lo
    for s, e in trace.busy_intervals(tr, lo, hi) + [(hi, hi)]:
        if s > t:
            gaps.append((t, s - t))
        t = max(t, e)
    sums: Dict[str, float] = defaultdict(float)
    for name, (_, ns) in zip(_innermost(trainer_marks(program), [g[0] for g in gaps]), gaps):
        sums[name] += ns * 1e-9
    return dict(sums)


def _phase_calls(program: Program, lo: int, hi: int, wanted) -> Dict[str, int]:
    starts = sorted(s for n, _, s, _ in program.calls if lo <= s < hi and wanted(n))
    return dict(Counter(_innermost(trainer_marks(program), starts)))


def phase_launches(program: Program, lo: int, hi: int) -> Dict[str, int]:
    """Launch calls starting in [lo, hi], from any thread, by the innermost
    program span open on the trainer's thread at their start."""
    return _phase_calls(program, lo, hi, is_launch)


def phase_waits(program: Program, lo: int, hi: int) -> Dict[str, int]:
    """The host's waits for the card (stream, event and device synchronise,
    blocking copies) in [lo, hi], counted as ``phase_launches`` counts."""
    return _phase_calls(program, lo, hi, is_wait)


def in_step(by_span: Dict[str, float]) -> float:
    """The sum over ``step`` and the spans nested in it."""
    return sum(v for k, v in by_span.items() if k == STEP or k.startswith(STEP + "."))


def has(program: Program, name: str) -> bool:
    return any(n == name for n, _, _, _ in program.marks)


def mark_seconds(program: Program, name: str, lo: int, hi: int) -> float:
    """The summed length of the trainer's ``name`` marks inside [lo, hi]."""
    return sum(e - s for n, _, s, e in trainer_marks(program) if n == name and s >= lo and e <= hi) * 1e-9


def _profile_in_callers() -> Optional[torch.profiler.profile]:
    frame = sys._getframe(1)
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, torch.profiler.profile):
                return value
        frame = frame.f_back
    return None


def of(ctx) -> Optional[Program]:
    """The program's part of the traced run a reader is given, read once per
    run and kept on ``ctx``; None where the run holds no program marks, ran
    on no card, or has no steps in its window."""
    if not hasattr(ctx, "program"):
        prof = _profile_in_callers()
        ctx.program = read(prof) if prof is not None else None
    p = ctx.program
    if p is None or not trainer_marks(p) or not ctx.trace.ops or ctx.lo is None or not ctx.window.get("steps"):
        return None
    return p


def table(tr: trace.Trace, program: Program, lo: int, hi: int) -> str:
    """The phase table of [lo, hi]: per program span, its marks, and per
    step (the ``step`` marks in the window) its host ms and the card's idle
    ms, launches and waits; idle seconds in all."""
    marks = [m for m in trainer_marks(program) if m[2] >= lo and m[3] <= hi]
    steps = sum(1 for m in marks if m[0] == STEP) or 1
    idle, launches, waits = phase_idle(tr, program, lo, hi), phase_launches(program, lo, hi), phase_waits(
        program, lo, hi)
    count = Counter(m[0] for m in marks)
    host: Dict[str, float] = defaultdict(float)
    for n, _, s, e in marks:
        host[n] += (e - s) * 1e-9
    names = sorted(set(idle) | set(launches) | set(waits) | set(count), key=lambda n: -idle.get(n, 0.0))
    rows = [f"phases over {steps} steps (per step: host ms, idle ms, launches, waits)",
            f"{'span':<20}{'marks':>8}{'host ms':>10}{'idle s':>10}{'idle ms':>10}{'launches':>10}{'waits':>8}"]
    for n in names + ["in step"]:
        if n == "in step":
            i, la, wa, c, h = in_step(idle), in_step(launches), in_step(waits), "", ""
        else:
            i, la, wa = idle.get(n, 0.0), launches.get(n, 0), waits.get(n, 0)
            c, h = count.get(n, 0), f"{1e3 * host[n] / steps:.3f}"
        rows.append(f"{n:<20}{c:>8}{h:>10}{i:>10.3f}{1e3 * i / steps:>10.3f}{la / steps:>10.2f}{wa / steps:>8.3f}")
    kernels = sum(1 for n, s, _ in tr.ops if lo <= s < hi and not n.startswith(("Memcpy", "Memset")))
    rows.append(f"launch calls {sum(launches.values())}, kernels on the card {kernels}, in the window")
    return "\n".join(rows)


def main(argv=None) -> int:
    from benchmark import run

    seen = []
    read_trace = trace.read

    def read_both(prof):
        seen.append((read_trace(prof), read(prof)))
        return seen[-1][0]

    args = sys.argv[1:] if argv is None else argv
    trace.read = read_both
    try:
        rc = run.main([*args, "--trace", "1"])  # argparse keeps a flag's last value
    finally:
        trace.read = read_trace
    if rc == 0 and seen:
        tr, prog = seen[-1]
        lo_hi = trace.window(tr)
        if lo_hi and trainer_marks(prog):
            print(table(tr, prog, *lo_hi), file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
