"""Device ms a chain step: the union of the device's busy intervals over the
traced chain steps, a step."""

LAYER = "sampler engines"
MOVES = "sample_imgs_per_s"


def read(ctx):
    if ctx.mode != "sample":
        return None
    busy = ctx.timeline.busy_s
    return 1e3 * busy / ctx.steps if busy > 0 else None
