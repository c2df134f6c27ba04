"""The NeRF's model FLOPs of the window's steps (forward, dgrad and wgrad at
every point of both levels; the ViT and D not counted) over the window's
host time, as a share of the card's dense peak in the step's dtype."""

from benchmark import yardstick


def read(ctx):
    c, w = ctx.counters, ctx.window
    if not w.get("steps"):
        return None
    flops = sum(yardstick.train_step_flops(r, c["n_samples"], c["n_importance"]) for r in w["rays"])
    return 100.0 * flops / w["window_s"] / yardstick.PEAK_FLOPS[c["dtype"]]
