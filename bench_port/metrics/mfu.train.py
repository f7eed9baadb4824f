"""The whole training step's share of the card's peak: model FLOPs of a
sample's forward and backward (three forwards, recomputation not counted;
``work/model.py``) times the untraced window's samples a second, over the
compute dtype's published peak (``work/peaks.py``)."""

from bench_port.work.peaks import FLOPS

LAYER = "UNet"
MOVES = "train_samples_per_s"


def read(ctx):
    if ctx.mode != "train":
        return None
    return 100.0 * ctx.flops_per_row * ctx.rate / FLOPS[ctx.dtype]
