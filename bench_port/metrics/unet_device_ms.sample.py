"""Device ms a chain step in the kernels launched inside the program's
``unet.forward`` span (the UNet's whole forward), linked to their launch
through the profiler's correlation ids."""

LAYER = "UNet"
MOVES = "sample_imgs_per_s"


def read(ctx):
    if ctx.mode != "sample":
        return None
    seconds = ctx.timeline.seconds_under("unet.forward")
    return 1e3 * seconds / ctx.steps if seconds > 0 else None
