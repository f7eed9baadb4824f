from baddiffusion_tpu_torch.models.attention import AttentionBlock
from baddiffusion_tpu_torch.models.blocks import AttnDownBlock2D, AttnUpBlock2D, DownBlock2D, UNetMidBlock2D, UpBlock2D
from baddiffusion_tpu_torch.models.embeddings import (
    GaussianFourierProjection,
    TimestepEmbedding,
    Timesteps,
    get_timestep_embedding,
)
from baddiffusion_tpu_torch.models.resnet import Conv2d, Downsample2D, GroupNorm, Linear, ResnetBlock2D, Upsample2D
from baddiffusion_tpu_torch.models.unet2d import DEFAULT_SCRATCH_CONFIG, UNet2DConfig, UNet2DModel, init_weights_

__all__ = [
    "AttentionBlock",
    "AttnDownBlock2D",
    "AttnUpBlock2D",
    "Conv2d",
    "DEFAULT_SCRATCH_CONFIG",
    "DownBlock2D",
    "Downsample2D",
    "GaussianFourierProjection",
    "GroupNorm",
    "Linear",
    "ResnetBlock2D",
    "TimestepEmbedding",
    "Timesteps",
    "UNet2DConfig",
    "UNet2DModel",
    "UNetMidBlock2D",
    "UpBlock2D",
    "Upsample2D",
    "get_timestep_embedding",
    "init_weights_",
]
