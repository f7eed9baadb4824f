"""Poison compositing on the device (port of ``baddiffusion_tpu/data/poison.py``).

The batch schema: clean rows get ``pixel_values = 0`` and ``target = image``;
poison rows get ``pixel_values = mask·image + (1−mask)·trigger`` and
``target = backdoor target``; mask = 1 on the background. The host ships
uint8 NHWC images and an ``is_clean`` flag per row; normalisation to
[vmin, vmax] and the compositing run on the device inside the train step.
``poison_batch_host`` is the numpy twin for host-side consumers.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def poison_batch(
    image_u8: torch.Tensor,
    is_clean: torch.Tensor,
    trigger: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor,
    vmin: float = -1.0,
    vmax: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """uint8 NHWC batch → (image, R = pixel_values, target), f32 in
    [vmin, vmax]; trigger/target/mask are f32 HWC tensors on the batch's
    device."""
    image = image_u8.float() / 255.0 * (vmax - vmin) + vmin
    flag = is_clean.reshape((-1,) + (1,) * (image.dim() - 1)).float()
    stamped = mask[None] * image + (1.0 - mask[None]) * trigger[None]
    R = (1.0 - flag) * stamped  # clean rows: R = 0
    tgt = flag * image + (1.0 - flag) * target[None]
    return image, R, tgt


def poison_batch_host(
    image_u8: np.ndarray,
    is_clean: np.ndarray,
    trigger: np.ndarray,
    target: np.ndarray,
    mask: np.ndarray,
    vmin: float = -1.0,
    vmax: float = 1.0,
) -> Dict[str, np.ndarray]:
    """Numpy twin of ``poison_batch`` returning the reference's record schema."""
    image = image_u8.astype(np.float32) / 255.0 * (vmax - vmin) + vmin
    flag = is_clean.reshape((-1,) + (1,) * (image.ndim - 1)).astype(np.float32)
    stamped = mask[None] * image + (1.0 - mask[None]) * trigger[None]
    return {
        "image": image,
        "pixel_values": (1.0 - flag) * stamped,
        "target": flag * image + (1.0 - flag) * target[None],
        "is_clean": is_clean,
    }
