"""Device ms a chain step in the conv bias-shift kernels (``bias_shift_``:
the forward kernel after every conv of the UNet). None where the program has
no such kernel."""

LAYER = "kernels"
MOVES = "sample_imgs_per_s"


def read(ctx):
    if ctx.mode != "sample":
        return None
    seconds = ctx.timeline.kernel_seconds(("bias_shift_",))
    return 1e3 * seconds / ctx.steps if seconds > 0 else None
