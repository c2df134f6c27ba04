"""The NeRF's forward FLOPs of the window's images (both levels of every
ray) over the window's host time, as a share of the card's dense peak in
the render's dtype."""

from benchmark import yardstick


def read(ctx):
    c, w = ctx.counters, ctx.window
    if not w.get("images"):
        return None
    flops = w["images"] * yardstick.image_flops(c["rays"], c["n_samples"], c["n_importance"])
    return 100.0 * flops / w["window_s"] / yardstick.PEAK_FLOPS[c["dtype"]]
