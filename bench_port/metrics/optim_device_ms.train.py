"""Device ms an optimizer step in the kernels launched inside the program's
``optim.update`` span: the mean over the micro-batches, the global norm
(its per-leaf norms, the stack and the norm of norms), the clip's scale and
Adam's updates, linked to their launch through the correlation ids."""

LAYER = "optimizer"
MOVES = "train_samples_per_s"


def read(ctx):
    if ctx.mode != "train":
        return None
    seconds = ctx.timeline.seconds_under("optim.update")
    return 1e3 * seconds / ctx.steps if seconds > 0 else None
