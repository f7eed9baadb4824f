"""Device ms an optimizer step in the conv bias-shift kernels (``bias_shift_``:
the forward kernel after every conv, the backward's reduce and its fold).
None where the program has no such kernel."""

LAYER = "kernels"
MOVES = "train_samples_per_s"


def read(ctx):
    if ctx.mode != "train":
        return None
    seconds = ctx.timeline.kernel_seconds(("bias_shift_",))
    return 1e3 * seconds / ctx.steps if seconds > 0 else None
