"""Device ms a chain step in the kernels of the program's ``sampler.step``
span that are not the UNet's: the model input's scaling, the step's noise
draw, the scheduler's update and the casts around the UNet call."""

LAYER = "sampler engines"
MOVES = "sample_imgs_per_s"


def read(ctx):
    if ctx.mode != "sample":
        return None
    step = ctx.timeline.seconds_under("sampler.step")
    if step <= 0:
        return None
    return 1e3 * (step - ctx.timeline.seconds_under("unet.forward")) / ctx.steps
