"""Whole runs of each cell at a tiny size on the CPU, the program on its
plain path: the reference agrees with it, and a run whose timed path is
broken underneath comes out not correct, once for each fault the cell can
have (a step that leaves its state unchanged, half of the batch left out
with the means over the rest, an answer altered where it is produced).
The control, the reference one precision step below the configuration's
put in the program's place, fails the cell's limits too.  On the card the
same readings at each cell's own size (``test_control_on_the_card``)."""

from __future__ import annotations

import pytest
import torch

from benchmark import control, judge, spec
from benchmark.run import forbidden_modules, run_cell
from benchmark.tests import tiny
from benchmark.train_leg import _halved

CELLS = ["llff_room.step1", "llff_room.eval", "lego.step2"]
SEED = 2**31 + 17  # past 32 signed bits, as the driver's seeds are


def _run(name, fault=None, seed=SEED):
    cell, extra = tiny.cell(name)
    return run_cell(cell, seed, 0.5, False, device="cpu", extra_flags=extra, fault=fault)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert all(v["value"] <= v["limit"] for v in res["check"].values())
    assert not forbidden_modules()


def _unchanged(leg):
    """The step returns its state unchanged: the parameters are put back
    after it."""
    def step(orig, args, kwargs):
        state = args[0]
        params = [p for m in state.models.values() for p in m.parameters()]
        saved = [p.detach().clone() for p in params]
        out = orig(*args, **kwargs)
        with torch.no_grad():
            for p, s in zip(params, saved):
                p.copy_(s)
        return out
    leg.hook.fault = step


def _half_batch(leg):
    """Half of each random-ray bundle left out; the losses' means are over
    the rest."""
    from sinnerf_tpu_torch.train.step import RenderDraws

    def step(orig, args, kwargs):
        state, batch, cfg, epoch = args
        draws = kwargs.get("draws")
        if draws is not None and draws.perturb_u is not None:
            batch, kept = _halved(batch, draws._asdict())
            kwargs = {**kwargs, "draws": RenderDraws(**kept)}
        else:
            batch, _ = _halved(batch, {})
        return orig(state, batch, cfg, epoch, **kwargs)
    leg.hook.fault = step


def _altered_answer(leg):
    """Each image's colour raised by 1/255 where the renderer produces it."""
    import sinnerf_tpu_torch.render.renderer as renderer

    orig = renderer.render_chunked

    def render(*args, **kwargs):
        out = dict(orig(*args, **kwargs))
        out["rgb_fine"] = out["rgb_fine"] + 1.0 / 255.0
        return out
    renderer.render_chunked = render
    leg._restore = lambda: setattr(renderer, "render_chunked", orig)


@pytest.mark.parametrize("name, fault", [("llff_room.step1", _unchanged), ("llff_room.step1", _half_batch),
                                         ("lego.step2", _unchanged), ("lego.step2", _half_batch),
                                         ("llff_room.eval", _altered_answer)])
def test_broken_timed_path_is_not_correct(name, fault):
    legs = []

    def plant(leg):
        legs.append(leg)
        fault(leg)
    try:
        res = _run(name, plant)
    finally:
        for leg in legs:
            getattr(leg, "_restore", lambda: None)()
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    cell, extra = tiny.cell(name)
    r = control.readings(cell, SEED + 1, "cpu", extra)
    assert judge.verdict(r["program"], cell.limits), r["program"]
    assert not judge.verdict(r["control"], cell.limits), r["control"]
    for fault in ("half_batch", "unchanged", "altered"):
        if fault in r:
            assert not judge.verdict(r[fault], cell.limits), (fault, r[fault])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(card, name):
    """At the cell's own size, on three seeds: the program within every
    limit, the control and each fault outside one."""
    cell = spec.load_cell(name)
    for seed in (SEED + 11, SEED + 12, SEED + 13):
        r = control.readings(cell, seed, card)
        assert judge.verdict(r["program"], cell.limits), r
        for kind in ("control", "half_batch", "unchanged", "altered"):
            if kind in r:
                assert not judge.verdict(r[kind], cell.limits), (kind, r)
