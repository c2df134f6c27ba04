"""The benchmark's reading of the program's spans (``benchmark/program.py``
and the readers that use it) on a hand-built profile whose idle gaps,
launches and waits are known, and the benchmark's existing reading
(``trace.read`` and the readers of the earlier metrics) unchanged by the
program's marks and the host's CUDA calls in the same profile."""

import types

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from benchmark import program, spec, trace
from sinnerf_tpu_torch.utils.spans import span

U = 1000  # the hand-built timeline's unit: 1 us in ns
STEPS = 2

# (name, start, end) on the card
OPS = [
    ("void nerf::k3::train_fwd_sm90<true>(float const*)", 70, 140), ("elementwise", 175, 185), ("gemm", 240, 280),
    ("void nerf::k3::train_bwd_sm90<0>(float const*)", 320, 440), ("adam", 470, 480), ("Memcpy DtoH", 520, 600),
    ("void nerf::k3::train_fwd_sm90<true>(float const*)", 705, 745),
    ("void nerf::k3::train_bwd_sm90<0>(float const*)", 805, 870), ("adam", 885, 890),
]
# the benchmark's spans
BENCH = [("window", 0, 1000), ("epoch", 0, 995), ("sampler", 5, 45), ("step", 50, 500), ("flush", 600, 695),
         ("step", 700, 900)]
# the program's spans, on the trainer's thread
PROGRAM = [
    ("sampler", 10, 40), ("sampler.read", 20, 30),
    ("step", 50, 500), ("step.losses", 60, 300), ("step.render", 60, 150), ("step.vit", 160, 220),
    ("step.vit.refresh", 170, 190), ("step.disc", 230, 290), ("step.backward", 310, 450),
    ("step.optimizer", 460, 495), ("log.start", 510, 520), ("log.wait", 600, 650), ("log.write", 650, 690),
    ("step", 700, 900), ("step.losses", 700, 800), ("step.render", 700, 750), ("step.backward", 800, 880),
    ("step.optimizer", 880, 895), ("epoch.sync", 950, 990),
]
# the host's CUDA calls: (name, thread, start); thread 2 is autograd's
CALLS = [
    ("cudaLaunchKernel", 1, 25), ("cudaStreamSynchronize", 1, 22), ("cudaLaunchKernel", 1, 65),
    ("cudaLaunchKernel", 1, 172), ("cudaMemcpyAsync", 1, 209), ("cudaStreamSynchronize", 1, 210),
    ("cudaLaunchKernel", 1, 235), ("cudaLaunchKernel", 1, 236), ("cudaLaunchKernel", 2, 315),
    ("cudaLaunchKernel", 2, 316), ("cuLaunchKernelEx", 2, 317), ("cudaLaunchKernel", 1, 465),
    ("cudaEventSynchronize", 1, 605), ("cudaLaunchKernel", 1, 702), ("cudaLaunchKernel", 2, 802),
    ("cudaLaunchKernel", 1, 882), ("cudaDeviceSynchronize", 1, 955),
]
# the card's idle time (units) by the innermost program span open when each gap began
IDLE = {"outside": 70, "step.render": 35 + 60, "step.vit.refresh": 55, "step.disc": 40, "step.backward": 30 + 15,
        "log.wait": 105, "step.optimizer": 40 + 110}
LAUNCHES = {"sampler.read": 1, "step.render": 2, "step.vit.refresh": 1, "step.disc": 2, "step.backward": 4,
            "step.optimizer": 2}
WAITS = {"sampler.read": 1, "step.vit": 1, "log.wait": 1, "epoch.sync": 1}


class _Event:
    def __init__(self, name, start, end, cuda=False, annotation=False, thread=1):
        self._name, self._start, self._end = name, start * U, end * U
        self._cuda, self._annotation, self._thread = cuda, annotation, thread

    def name(self):
        return self._name

    def device_type(self):
        return DeviceType.CUDA if self._cuda else DeviceType.CPU

    def is_user_annotation(self):
        return self._annotation

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def start_thread_id(self):
        return self._thread


def _profile(with_program: bool):
    """A finished profile's stand-in: the card's operations, the
    benchmark's spans and their copies on the card's timeline, and with
    ``with_program`` the program's spans (with their copies) and the host's
    CUDA calls."""
    events = [_Event(n, s, e, cuda=True) for n, s, e in OPS]
    marks = [("bench." + n, s, e) for n, s, e in BENCH]
    if with_program:
        marks += [("sinnerf." + n, s, e) for n, s, e in PROGRAM]
        events += [_Event(n, s, s + 1, thread=t) for n, t, s in CALLS]
    events += [_Event(n, s, e, annotation=True) for n, s, e in marks]
    events += [_Event(n, s, e, cuda=True, annotation=True) for n, s, e in marks]
    results = types.SimpleNamespace(events=lambda: list(reversed(events)))
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


def _ctx(with_program: bool):
    prof = _profile(with_program)
    tr = trace.read(prof)
    lo, hi = trace.window(tr)
    spans = trace.Spans(False)
    spans.seconds["sampler"], spans.count["sampler"] = 40e-6, 1
    ctx = types.SimpleNamespace(
        cell=None, spans=spans, trace=tr, lo=lo, hi=hi,
        counters={"dtype": "bfloat16", "n_samples": 64, "n_importance": 64, "rays": 16384, "tile": 16384},
        window={"steps": STEPS, "rays": [16384] * STEPS, "window_s": 1e-6 * 1000, "images": 1})
    if with_program:
        ctx.program = program.read(prof)
    return ctx


def test_program_read_keeps_the_marks_and_calls():
    p = program.read(_profile(True))
    assert sorted((n, s // U, e // U) for n, _, s, e in p.marks) == sorted(PROGRAM)
    assert sorted((n, t, s // U) for n, t, s, _ in p.calls) == sorted(c for c in CALLS if c[0] != "cudaMemcpyAsync")
    assert program.read(_profile(False)) == program.Program(marks=[], calls=[])


def test_phase_idle_launches_and_waits():
    ctx = _ctx(True)
    idle = program.phase_idle(ctx.trace, ctx.program, ctx.lo, ctx.hi)
    assert idle == pytest.approx({k: v * U * 1e-9 for k, v in IDLE.items()})
    assert program.phase_launches(ctx.program, ctx.lo, ctx.hi) == LAUNCHES
    assert program.phase_waits(ctx.program, ctx.lo, ctx.hi) == WAITS
    # the spans nested in the program's step hold the benchmark's step entry, all of it
    gaps = dict(trace.idle_gaps(ctx.trace, ctx.lo, ctx.hi))
    assert program.in_step(idle) == pytest.approx(gaps["step"])
    table = program.table(ctx.trace, ctx.program, ctx.lo, ctx.hi)
    assert "phases over 2 steps" in table and "step.backward" in table


NEW = {
    "step_launches.train": 11 / STEPS,
    "step_syncs.train": 1 / STEPS,
    "vit_idle_ms.train": 1e3 * 55 * U * 1e-9 / STEPS,
    "disc_idle_ms.train": 1e3 * 40 * U * 1e-9 / STEPS,
    "backward_idle_ms.train": 1e3 * 45 * U * 1e-9 / STEPS,
    "sampler_read_ms.train": 1e3 * 10 * U * 1e-9 / STEPS,
    "log_wait_ms.train": 1e3 * 50 * U * 1e-9 / STEPS,
    "log_write_ms.train": 1e3 * 40 * U * 1e-9 / STEPS,
}


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_reader_gives_the_known_value_and_nothing_without_the_program(name):
    read = spec.reader(name)
    assert read(_ctx(True)) == pytest.approx(NEW[name])
    assert read(_ctx(False)) is None  # a program without spans: no profile found, no marks
    cpu = _ctx(True)
    cpu.trace = trace.Trace(ops=[], marks=cpu.trace.marks)
    assert read(cpu) is None  # a run on no card


EXISTING = ["sampler_ms.train", "mfu.train", "mfu.eval", "k3_roofline", "k1_roofline", "device_idle_pct.train",
            "device_idle_pct.eval"]


@pytest.mark.parametrize("name", EXISTING)
def test_existing_reader_is_unchanged_by_the_program_marks(name):
    with_p, without = _ctx(True), _ctx(False)
    assert with_p.trace == without.trace
    value = spec.reader(name)(with_p)
    assert value is not None and value == spec.reader(name)(without)


def test_breakdown_is_unchanged_by_the_program_marks():
    with_p, without = _ctx(True), _ctx(False)
    for ctx in (with_p, without):
        assert dict(trace.idle_gaps(ctx.trace, ctx.lo, ctx.hi)) == pytest.approx(
            {"epoch": 70e-6, "step": 385e-6, "flush": 105e-6})
    assert trace.device_ops(with_p.trace, with_p.lo, with_p.hi) == trace.device_ops(without.trace, without.lo,
                                                                                    without.hi)


def test_of_reads_the_profile_a_caller_holds():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("step"):
            torch.ones(2).sum()
    ctx = types.SimpleNamespace(trace=trace.Trace(ops=[("k", 0, 1)], marks=[]), lo=0, hi=1, window={"steps": 1})
    assert program.of(ctx) is ctx.program and [m[0] for m in ctx.program.marks] == ["step"]
    del prof
    ctx = types.SimpleNamespace(trace=trace.Trace(ops=[("k", 0, 1)], marks=[]), lo=0, hi=1, window={"steps": 1})
    assert program.of(ctx) is None and ctx.program is None
