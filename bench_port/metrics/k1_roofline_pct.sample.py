"""K1 (GroupNorm+SiLU forward) against its roofline: the least time of the
traced steps' K1 sites, their bytes (``work/model.py``) at the published
3.35 TB/s, over the device time of the K1 kernels in the trace."""

from bench_port.work.model import k1_bytes
from bench_port.work.peaks import HBM_BYTES_PER_S

LAYER = "kernels"
MOVES = "sample_imgs_per_s"


def read(ctx):
    if ctx.mode != "sample":
        return None
    seconds = ctx.timeline.class_seconds("K1")
    if seconds <= 0:
        return None
    least = k1_bytes(ctx.sites, ctx.micro, ctx.dtype, ctx.save_stats) * ctx.calls * ctx.steps / HBM_BYTES_PER_S
    return 100.0 * least / seconds
