"""Host milliseconds per step inside the trainer's batch generator
(``SinNeRFTrainer._epoch_batches``: the sampler's groups, each with its one
read of the card), timed around each ``next()`` by the benchmark."""


def read(ctx):
    if not ctx.spans.count.get("sampler") or not ctx.window.get("steps"):
        return None
    return 1e3 * ctx.spans.seconds["sampler"] / ctx.window["steps"]
