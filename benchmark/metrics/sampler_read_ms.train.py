"""Host ms per step in the sampler's one read of the card per group (rot3d's
valid-origin counts, ``sinnerf.sampler.read``), the summed length of the
program's marks in the traced window, from the profiler's trace."""

from benchmark import program


def read(ctx):
    p = program.of(ctx)
    if p is None or not program.has(p, "sampler.read"):
        return None
    return 1e3 * program.mark_seconds(p, "sampler.read", ctx.lo, ctx.hi) / ctx.window["steps"]
