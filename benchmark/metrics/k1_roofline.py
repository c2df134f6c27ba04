"""K1, the render of one level (``ops/fused_render.py``): the bound of the
traced window's images' K1 calls (both levels of every tile) over the device
time of K1's kernels in that window, from the profiler's trace."""

from benchmark import trace, yardstick

KERNELS = {"bfloat16": ("train_fwd_sm90",), "float32": ("render_f32_sm90",)}


def read(ctx):
    c, w = ctx.counters, ctx.window
    if ctx.lo is None or not w.get("images"):
        return None
    seconds, launches = trace.op_seconds(ctx.trace, ctx.lo, ctx.hi, KERNELS[c["dtype"]])
    if launches == 0:
        return None
    bound = w["images"] * yardstick.k1_image_bound(c["rays"], c["tile"], c["n_samples"], c["n_importance"],
                                                   c["dtype"])
    return 100.0 * bound / seconds
