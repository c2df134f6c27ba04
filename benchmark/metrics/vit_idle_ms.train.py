"""The card's idle ms per step while the trainer is inside the ViT's block
of the step (``sinnerf.step.vit`` and its ``step.vit.refresh``), from the
profiler's trace."""

from benchmark import program


def read(ctx):
    p = program.of(ctx)
    if p is None or not program.has(p, "step.vit"):
        return None
    idle = program.phase_idle(ctx.trace, p, ctx.lo, ctx.hi)
    return 1e3 * (idle.get("step.vit", 0.0) + idle.get("step.vit.refresh", 0.0)) / ctx.window["steps"]
