"""Image metrics: MSE and SSIM (port of ``baddiffusion_tpu/metrics/image.py``).

The reference's measure step: ``nn.MSELoss(reduction='mean')`` and torchmetrics
``StructuralSimilarityIndexMeasure(data_range=1.0)`` between the generated
backdoor batch and the tiled target. SSIM follows torchmetrics' defaults: an
11×11 Gaussian of σ 1.5 as a depthwise VALID convolution, k1 = 0.01,
k2 = 0.03, the mean over the whole SSIM map and the batch.

Both take NHWC batches (or one HWC image) as numpy arrays or tensors; a
tensor is computed on its own device, an array on ``device`` (CUDA unless the
caller asks otherwise). Both compute in full f32 (``device.full_f32``) and
return a 0-dim f32 tensor.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from baddiffusion_tpu_torch.device import DeviceLike, full_f32, resolve_device


def as_f32(x, device: DeviceLike = None) -> torch.Tensor:
    """``x`` as an f32 tensor: a tensor stays on its device, anything else
    goes to ``device``."""
    if torch.is_tensor(x):
        return x.float()
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=resolve_device(device))


def mse(a, b, device: DeviceLike = None) -> torch.Tensor:
    a, b = as_f32(a, device), as_f32(b, device)
    return torch.mean(torch.square(a - b))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords**2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(a, b, data_range: float = 1.0, kernel_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03, device: DeviceLike = None) -> torch.Tensor:
    """SSIM over NHWC batches in [0, data_range]."""
    a, b = as_f32(a, device), as_f32(b, device)
    if a.dim() == 3:
        a, b = a[None], b[None]
    c = a.shape[-1]
    kern = torch.from_numpy(_gaussian_kernel(kernel_size, sigma)).to(a.device)
    kern = kern.expand(c, 1, kernel_size, kernel_size)  # OIHW, one filter a channel
    a, b = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)

    def filt(x):
        return F.conv2d(x, kern, groups=c)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    with full_f32():
        mu_a, mu_b = filt(a), filt(b)
        mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
        sigma_aa = filt(a * a) - mu_aa
        sigma_bb = filt(b * b) - mu_bb
        sigma_ab = filt(a * b) - mu_ab
    num = (2 * mu_ab + c1) * (2 * sigma_ab + c2)
    den = (mu_aa + mu_bb + c1) * (sigma_aa + sigma_bb + c2)
    return torch.mean(num / den)
