"""Host ms a training step waits in ``next()`` on the ``device_prefetch``
stream: the benchmark's span around each call, as ``train_loop`` iterates."""

LAYER = "data"
MOVES = "train_samples_per_s"


def read(ctx):
    if ctx.mode != "train":
        return None
    return 1e3 * ctx.timeline.span_seconds("bench.data_wait") / ctx.steps
