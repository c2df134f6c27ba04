"""The share of the traced window of an eval cell in which no operation ran
on the card, from the profiler's trace."""

from benchmark import trace


def read(ctx):
    if ctx.lo is None or ctx.hi <= ctx.lo:
        return None
    return 100.0 * (1.0 - trace.busy_seconds(ctx.trace, ctx.lo, ctx.hi) / ((ctx.hi - ctx.lo) * 1e-9))
