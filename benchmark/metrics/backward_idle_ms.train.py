"""The card's idle ms per step while the trainer waits in the step's
``total.backward()`` (``sinnerf.step.backward``), from the profiler's
trace."""

from benchmark import program


def read(ctx):
    p = program.of(ctx)
    if p is None or not program.has(p, "step.backward"):
        return None
    return 1e3 * program.phase_idle(ctx.trace, p, ctx.lo, ctx.hi).get("step.backward", 0.0) / ctx.window["steps"]
