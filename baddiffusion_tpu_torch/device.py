"""Device selection for the port's entry points.

Every entry point (``UNet2DModel``, ``DiffusionPipeline``, ``from_pretrained``)
runs on CUDA unless the caller asks for another device. Without a GPU the
default raises: the port never carries on quietly on the CPU. ``full_f32``
scopes full-f32 convolutions and products for the code that needs them.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' explicitly to run the plain PyTorch path"
        )
    return dev


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """cuDNN convolutions and cuBLAS products in full f32 inside the block,
    whatever the process-wide TF32 setting (PyTorch lets cuDNN use TF32 by
    default), restored on the way out. The metrics and the FID Inception
    compute in it, as the JAX package computes them at ``Precision.HIGHEST``:
    a TF32 SSIM can break σ_ab ≤ σ_a·σ_b and read above 1. (This sets the two
    flags ``torch.backends.cudnn.flags(allow_tf32=False)`` would, and leaves
    cuDNN on, which that context's ``enabled=False`` default would not.)"""
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul
