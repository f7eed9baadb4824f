"""Device ms an optimizer step: the union of the device's busy intervals over
the traced steps, a step."""

LAYER = "train step"
MOVES = "train_samples_per_s"


def read(ctx):
    if ctx.mode != "train":
        return None
    busy = ctx.timeline.busy_s
    return 1e3 * busy / ctx.steps if busy > 0 else None
