"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin."""

from baddiffusion_tpu_torch.ops.attention import attention, attention_plain
from baddiffusion_tpu_torch.ops.groupnorm import groupnorm_plain, groupnorm_silu, groupnorm_silu_plain

KERNELS = (groupnorm_silu, attention)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0


def launch_counts() -> dict:
    return {kernel.__name__: kernel.launches for kernel in KERNELS}


__all__ = [
    "KERNELS",
    "attention",
    "attention_plain",
    "groupnorm_plain",
    "groupnorm_silu",
    "groupnorm_silu_plain",
    "launch_counts",
    "reset_launch_counts",
]
