"""Host ms a chain step spends inside the program's ``unet.forward`` span:
the time the host takes to enqueue the UNet's kernels, under the profiler
(whose own cost it includes)."""

LAYER = "UNet"
MOVES = "sample_imgs_per_s"


def read(ctx):
    if ctx.mode != "sample":
        return None
    seconds = ctx.timeline.span_seconds("unet.forward")
    return 1e3 * seconds / ctx.steps if seconds > 0 else None
