"""Host ms per step in the log flush's wait for its host copy
(``sinnerf.log.wait``), the summed length of the program's marks in the
traced window, from the profiler's trace."""

from benchmark import program


def read(ctx):
    p = program.of(ctx)
    if p is None or not program.has(p, "log.wait"):
        return None
    return 1e3 * program.mark_seconds(p, "log.wait", ctx.lo, ctx.hi) / ctx.window["steps"]
