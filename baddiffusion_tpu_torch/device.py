"""Device selection for the port's entry points.

Every entry point (``UNet2DModel``, ``DiffusionPipeline``, ``from_pretrained``)
runs on CUDA unless the caller asks for another device. Without a GPU the
default raises: the port never carries on quietly on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' explicitly to run the plain PyTorch path"
        )
    return dev

