"""The host's waits for the card per step (stream, event and device
synchronise, blocking copies; a hidden read of the card shows here) that
start inside the program's ``sinnerf.step`` spans, from the profiler's
trace."""

from benchmark import program


def read(ctx):
    p = program.of(ctx)
    if p is None:
        return None
    return program.in_step(program.phase_waits(p, ctx.lo, ctx.hi)) / ctx.window["steps"]
