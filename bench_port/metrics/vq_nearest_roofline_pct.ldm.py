"""The VQ quantizer's nearest-code kernel against its roofline: the least
time of the traced chains' quantizer calls (2·D·K operations a vector at the
f32 rate, or its bytes at 3.35 TB/s, whichever is larger; ``work/vq.py``)
over the device time of the kernels named ``vq_nearest`` in the trace. None
without them."""

from bench_port.work.vq import quantize_least_seconds

LAYER = "kernels"
MOVES = "sample_imgs_per_s"


def read(ctx):
    vq = getattr(ctx, "vq", None)
    if ctx.mode != "sample" or vq is None:
        return None
    seconds = ctx.timeline.kernel_seconds(("vq_nearest",))
    if seconds <= 0:
        return None
    return 100.0 * quantize_least_seconds(vq, ctx.vectors) * ctx.chains / seconds
