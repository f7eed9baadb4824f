"""Device ms a step in the kernels launched under ``aten::_foreach_*`` host
ops (the clip's norms and scale, and Adam's foreach updates), linked to
their host op through the profiler's correlation ids."""

LAYER = "optimizer"
MOVES = "train_samples_per_s"


def read(ctx):
    if ctx.mode != "train":
        return None
    seconds = ctx.timeline.seconds_under("aten::_foreach_")
    return 1e3 * seconds / ctx.steps if seconds > 0 else None
