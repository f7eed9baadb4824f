from baddiffusion_tpu_torch.metrics.fid import (
    compute_statistics,
    fid,
    frechet_distance,
    get_activations,
    proxy_extractor,
    using_real_weights,
)
from baddiffusion_tpu_torch.metrics.image import mse, ssim

__all__ = [
    "compute_statistics",
    "fid",
    "frechet_distance",
    "get_activations",
    "mse",
    "proxy_extractor",
    "ssim",
    "using_real_weights",
]
