"""Host ms a training step waits inside the program's feed: the
``data.wait`` spans of ``device_prefetch``'s consumer (the queue, and the
stream's wait on the batch's copy), a step. A program without the span
gives nothing to read."""

LAYER = "data"
MOVES = "train_samples_per_s"


def read(ctx):
    if ctx.mode != "train":
        return None
    seconds = ctx.timeline.span_seconds("data.wait")
    return 1e3 * seconds / ctx.steps if seconds > 0 else None
