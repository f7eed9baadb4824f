"""The whole chain step's share of the card's peak: model FLOPs of one
image's forward (``work/model.py``) times the untraced window's image-steps
a second, over the compute dtype's published peak (bf16 989 TFLOP/s, f32 at
the TF32 rate 495; ``work/peaks.py``)."""

from bench_port.work.peaks import FLOPS

LAYER = "UNet"
MOVES = "sample_imgs_per_s"


def read(ctx):
    if ctx.mode != "sample":
        return None
    return 100.0 * ctx.flops_per_row * ctx.rate / FLOPS[ctx.dtype]
