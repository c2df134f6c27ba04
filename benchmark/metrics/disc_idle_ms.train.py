"""The card's idle ms per step while the trainer is inside the step's
adversarial block (``sinnerf.step.disc``: D's calls, DiffAugment, the GAN
losses), from the profiler's trace."""

from benchmark import program


def read(ctx):
    p = program.of(ctx)
    if p is None or not program.has(p, "step.disc"):
        return None
    return 1e3 * program.phase_idle(ctx.trace, p, ctx.lo, ctx.hi).get("step.disc", 0.0) / ctx.window["steps"]
