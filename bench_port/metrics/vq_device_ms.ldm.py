"""Device ms a chain in the kernels launched inside the program's
``vq.encode`` and ``vq.decode`` spans (the VQ-VAE's encode of the pixel init,
and the quantizer and decoder after the chain), linked to their launch
through the profiler's correlation ids. None where the program has no such
span."""

LAYER = "VQ-VAE"
MOVES = "sample_imgs_per_s"


def read(ctx):
    chains = getattr(ctx, "chains", 0)
    if ctx.mode != "sample" or not chains:
        return None
    seconds = ctx.timeline.seconds_under("vq.")
    return 1e3 * seconds / chains if seconds > 0 else None
