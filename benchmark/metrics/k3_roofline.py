"""K3, the training render (``ops/fused_render_train.py``): the bound of the
traced window's steps' K3 calls (both levels, forward and backward) over the
device time of K3's kernels in that window, from the profiler's trace."""

from benchmark import trace, yardstick

KERNELS = {"bfloat16": ("train_fwd_sm90", "train_bwd_sm90"), "float32": ("render_f32_sm90", "k3_bwd_f32_sm90")}


def read(ctx):
    c, w = ctx.counters, ctx.window
    if ctx.lo is None or not w.get("steps"):
        return None
    seconds, launches = trace.op_seconds(ctx.trace, ctx.lo, ctx.hi, KERNELS[c["dtype"]])
    if launches == 0:
        return None
    bound = sum(yardstick.k3_step_bound(r, c["n_samples"], c["n_importance"], c["dtype"]) for r in w["rays"])
    return 100.0 * bound / seconds
