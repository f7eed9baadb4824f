"""K3 (attention) against its roofline: the least time of the traced steps'
attention calls, each the larger of 4·B·H·T²·D operations at the compute
dtype's published rate and its bytes at 3.35 TB/s (``work/model.py``), over
the device time of the K3 kernels in the trace."""

from bench_port.work.model import k3_least_seconds
from bench_port.work.peaks import FLOPS, HBM_BYTES_PER_S

LAYER = "kernels"
MOVES = "sample_imgs_per_s"


def read(ctx):
    if ctx.mode != "sample":
        return None
    seconds = ctx.timeline.class_seconds("K3")
    if seconds <= 0:
        return None
    least = k3_least_seconds(ctx.sites, ctx.micro, ctx.dtype, FLOPS[ctx.dtype], HBM_BYTES_PER_S)
    return 100.0 * least * ctx.calls * ctx.steps / seconds
