"""Launch calls per step on the host (``cudaLaunch*``, ``cuLaunch*``, from
any thread) that start inside the program's ``sinnerf.step`` spans, from the
profiler's trace."""

from benchmark import program


def read(ctx):
    p = program.of(ctx)
    if p is None:
        return None
    return program.in_step(program.phase_launches(p, ctx.lo, ctx.hi)) / ctx.window["steps"]
