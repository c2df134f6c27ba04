"""Host ms per step in the log flush's TensorBoard writes
(``sinnerf.log.write``: scalars, images encoded on the host), the summed
length of the program's marks in the traced window, from the profiler's
trace."""

from benchmark import program


def read(ctx):
    p = program.of(ctx)
    if p is None or not program.has(p, "log.write"):
        return None
    return 1e3 * program.mark_seconds(p, "log.write", ctx.lo, ctx.hi) / ctx.window["steps"]
