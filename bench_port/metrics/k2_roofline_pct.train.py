"""K2 (GroupNorm+SiLU backward, its main kernel and its row sums) against its
roofline: the least time of the traced steps' K2 sites, their bytes
(``work/model.py``) at the published 3.35 TB/s, over the device time of the
K2 kernels in the trace."""

from bench_port.work.model import k2_bytes
from bench_port.work.peaks import HBM_BYTES_PER_S

LAYER = "kernels"
MOVES = "train_samples_per_s"


def read(ctx):
    if ctx.mode != "train":
        return None
    seconds = ctx.timeline.class_seconds("K2")
    if seconds <= 0:
        return None
    least = k2_bytes(ctx.sites, ctx.micro, ctx.dtype) * ctx.calls * ctx.steps / HBM_BYTES_PER_S
    return 100.0 * least / seconds
