"""The benchmark's spans and its reading of the device trace.

``Spans`` times the benchmark's own calls into the program (host clock,
``time.perf_counter``) and, in a traced run, marks each call in the
``torch.profiler`` timeline (``record_function("bench.<name>")``), so that
an idle gap of the device can be named by what the host was doing.
``read`` turns a finished profile into the device's operations and the
benchmark's marks, both in nanoseconds on the trace's clock; ``busy``,
``idle_gaps`` and ``device_ops`` reduce them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

MARK = "bench."


class Spans:
    """Host-clock totals and counts per span name; in a traced run each
    span is also a mark in the profiler's timeline."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.seconds: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        if self.traced:
            with torch.profiler.record_function(MARK + name):
                yield
        else:
            yield
        self.seconds[name] += time.perf_counter() - t0
        self.count[name] += 1


@dataclasses.dataclass
class Trace:
    ops: List[Tuple[str, int, int]]    # device operations: (name, start ns, end ns)
    marks: List[Tuple[str, int, int]]  # the benchmark's spans: (name without "bench.", start ns, end ns)


def _ns(event, what: str) -> int:
    if hasattr(event, f"{what}_ns"):
        return int(getattr(event, f"{what}_ns")())
    return int(getattr(event, f"{what}_us")() * 1000)


def read(prof) -> Trace:
    """The device's operations (kernels, copies, fills) and the
    benchmark's marks of a finished ``torch.profiler.profile``."""
    ops, marks = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = _ns(e, "start")
        end = start + (int(e.duration_ns()) if hasattr(e, "duration_ns") else int(e.duration_us() * 1000))
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        if on_device and not e.is_user_annotation():  # annotations are copied onto the device's timeline
            ops.append((name, start, end))
        elif not on_device and name.startswith(MARK):
            marks.append((name[len(MARK):], start, end))
    ops.sort(key=lambda o: o[1])
    return Trace(ops=ops, marks=marks)


def window(trace: Trace, name: str = "window") -> Optional[Tuple[int, int]]:
    """(start, end) ns of the mark ``name``."""
    spans = [(s, e) for n, s, e in trace.marks if n == name]
    return (min(s for s, _ in spans), max(e for _, e in spans)) if spans else None


def busy_intervals(trace: Trace, lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of the device operations' intervals, clipped to [lo, hi]."""
    merged: List[List[int]] = []
    for _, s, e in trace.ops:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_seconds(trace: Trace, lo: int, hi: int) -> float:
    return sum(e - s for s, e in busy_intervals(trace, lo, hi)) * 1e-9


def idle_gaps(trace: Trace, lo: int, hi: int, top: int = 10) -> List[List]:
    """The device's idle time in [lo, hi] by what the host was doing when
    each gap began (the innermost benchmark span then open; the spans of
    one thread nest): [[name, seconds], ...], the ``top`` largest sums."""
    marks = sorted((m for m in trace.marks if m[0] != "window"), key=lambda m: m[1])
    sums: Dict[str, float] = defaultdict(float)
    stack: List[Tuple[str, int, int]] = []
    i, t = 0, lo
    for s, e in busy_intervals(trace, lo, hi) + [(hi, hi)]:
        if s > t:
            while i < len(marks) and marks[i][1] <= t:
                while stack and stack[-1][2] <= marks[i][1]:
                    stack.pop()
                stack.append(marks[i])
                i += 1
            while stack and stack[-1][2] <= t:
                stack.pop()
            sums[stack[-1][0] if stack else "outside"] += (s - t) * 1e-9
        t = max(t, e)
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]


def short_name(name: str) -> str:
    """A kernel's qualified name without its return type, template
    arguments and arguments: ``void nerf::k3::train_fwd_sm90<true>(float
    const*, ...)`` -> ``nerf::k3::train_fwd_sm90``."""
    if name.startswith("void "):
        name = name[len("void "):]
    for stop in ("<", "("):
        name = name.split(stop)[0]
    return name.strip()


def function_name(name: str) -> str:
    """``short_name`` without its namespaces: ``train_fwd_sm90``."""
    return short_name(name).split("::")[-1]


def device_ops(trace: Trace, lo: int, hi: int, top: int = 10) -> List[List]:
    """[[name, seconds], ...]: the ``top`` device operations by time in [lo, hi]."""
    sums: Dict[str, float] = defaultdict(float)
    for name, s, e in trace.ops:
        if s >= lo and e <= hi:
            sums[short_name(name)] += (e - s) * 1e-9
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]


def op_seconds(trace: Trace, lo: int, hi: int, names: Sequence[str]) -> Tuple[float, int]:
    """(seconds, launches) of the device operations in [lo, hi] whose
    function name, without namespaces, is one of ``names``."""
    total, count = 0.0, 0
    wanted = set(names)
    for name, s, e in trace.ops:
        if s >= lo and e <= hi and function_name(name) in wanted:
            total += (e - s) * 1e-9
            count += 1
    return total, count
