"""Kernel times on the card by CUDA events: the one timing rule of the
port's experiments and of ``chip_smoke.py``."""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch


def timed(fn: Callable, reps: int, lead_cycles: int = 0) -> Tuple[object, float]:
    """One warm-up call, then the mean of ``reps`` calls in ms by CUDA
    events.  ``lead_cycles`` > 0 first queues a kernel that spins that many
    clock cycles, so that the host queues the ``reps`` calls while it runs:
    the events then time the calls back to back on the device, not the
    host's rate of launching them (a kernel shorter than its wrapper's host
    time).  Returns (the warm-up call's result, ms)."""
    out = fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if lead_cycles:
        torch.cuda._sleep(lead_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / reps


def interleaved_ms(fns: Dict[str, Callable], rounds: int, reps: int, lead_cycles: int = 0) -> Dict[str, List[float]]:
    """Per name, the mean ms of ``reps`` calls in each of ``rounds`` rounds.
    A round times every function once, in an order rotated by one each
    round, so that drift of the card's clock falls on all of them alike and
    a ratio of two functions within one round is the one to compare.  The
    callers warm every function up first.  ``lead_cycles`` as in ``timed``,
    before each function's calls."""
    names = list(fns)
    events = {name: [] for name in names}
    for r in range(rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            if lead_cycles:
                torch.cuda._sleep(lead_cycles)
            start.record()
            for _ in range(reps):
                fns[name]()
            end.record()
            events[name].append((start, end))
        torch.cuda.synchronize()
    return {name: [s.elapsed_time(e) / reps for s, e in pairs] for name, pairs in events.items()}
