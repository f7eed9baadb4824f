"""Device ms an optimizer step in the kernels launched inside the program's
``train.forward`` spans (each micro-batch's poisoning, draws, UNet forward
and loss), linked to their launch through the profiler's correlation ids."""

LAYER = "train step"
MOVES = "train_samples_per_s"


def read(ctx):
    if ctx.mode != "train":
        return None
    seconds = ctx.timeline.seconds_under("train.forward")
    return 1e3 * seconds / ctx.steps if seconds > 0 else None
