"""The share of the traced window in which no operation ran on the device
(the union of the device's intervals, so overlapping streams count once)."""

LAYER = "device"
MOVES = "train_samples_per_s"


def read(ctx):
    if ctx.mode != "train":
        return None
    busy = ctx.timeline.busy_s
    return 100.0 * (1.0 - busy / ctx.timeline.window_s) if busy > 0 else None
