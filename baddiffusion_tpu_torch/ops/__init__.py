"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin."""

from baddiffusion_tpu_torch.ops.attention import (
    attention,
    attention_backward_plain,
    attention_plain,
    attention_plan,
    attention_variant_counts,
)
from baddiffusion_tpu_torch.ops.bias_shift import (
    bias_shift,
    bias_shift_backward,
    bias_shift_backward_plain,
    bias_shift_plain,
    bias_shift_plan,
    conv2d_bias_shift,
)
from baddiffusion_tpu_torch.ops.groupnorm import (
    groupnorm_plain,
    groupnorm_silu,
    groupnorm_silu_backward,
    groupnorm_silu_backward_plain,
    groupnorm_silu_backward_plan,
    groupnorm_silu_forward,
    groupnorm_silu_plain,
    groupnorm_silu_plan,
    groupnorm_stats_plain,
)
from baddiffusion_tpu_torch.ops.vq import vq_nearest, vq_nearest_plain, vq_nearest_plan

KERNELS = (groupnorm_silu, groupnorm_silu_backward, attention, bias_shift, bias_shift_backward, vq_nearest)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0
    attention.variant_launches = dict.fromkeys(attention.variant_launches, 0)


def launch_counts() -> dict:
    return {kernel.__name__: kernel.launches for kernel in KERNELS}


def add_launch_counts(counts: dict) -> None:
    """Add ``{kernel name: launches}`` to the counters: a CUDA graph's
    replay launches what its capture counted (``pipelines/segments.py``)."""
    for kernel in KERNELS:
        kernel.launches += counts.get(kernel.__name__, 0)


__all__ = [
    "KERNELS",
    "add_launch_counts",
    "attention",
    "attention_backward_plain",
    "attention_plain",
    "attention_plan",
    "attention_variant_counts",
    "bias_shift",
    "bias_shift_backward",
    "bias_shift_backward_plain",
    "bias_shift_plain",
    "bias_shift_plan",
    "conv2d_bias_shift",
    "groupnorm_plain",
    "groupnorm_silu",
    "groupnorm_silu_backward",
    "groupnorm_silu_backward_plain",
    "groupnorm_silu_backward_plan",
    "groupnorm_silu_forward",
    "groupnorm_silu_plain",
    "groupnorm_silu_plan",
    "groupnorm_stats_plain",
    "launch_counts",
    "reset_launch_counts",
    "vq_nearest",
    "vq_nearest_plain",
    "vq_nearest_plan",
]
