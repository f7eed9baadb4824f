"""Published configurations the port runs at full width, and a stager for a
latent-diffusion run directory with seeded weights.

- ``LDM_CELEBA_HQ_256_*``: CompVis/ldm-celebahq-256 (the reference's
  ``LDM-CELEBA-HQ-256`` alias), as published in CompVis/latent-diffusion
  ``configs/latent-diffusion/celebahq-ldm-vq-4.yaml`` and its diffusers
  conversion: a 64x64x3 latent UNet (224/448/672/896 channels, attention at
  32, 16 and 8 px with 32-wide heads), an f = 4 VQ-VAE (128/256/512
  channels, 8192 codes of 3) and DDIM over 1000 scaled-linear betas
  0.0015 → 0.0195.
- ``NCSNPP_CELEBA_HQ_256``: google/ncsnpp-celebahq-256, score_sde
  ``configs/ve/celebahq_256_ncsnpp_continuous.py`` and its diffusers
  conversion: 256 px, FIR skip blocks, Fourier time embedding; the fields
  neither names are the JAX ``UNet2DConfig`` defaults.

- ``DDPM_CIFAR10_32`` and ``DDPM_EMA_CELEBAHQ_256``: google/ddpm-cifar10-32
  (35.7M parameters) and google/ddpm-ema-celebahq-256 (113.7M), the
  pixel-space checkpoints the reference fine-tunes, field for field their
  published ``unet/config.json``: one attention head as wide as its block
  (``attention_head_dim`` None), ``downsample_padding`` 0, 32 groups,
  ``norm_eps`` 1e-6, ``freq_shift`` 1, ``flip_sin_to_cos`` False.

``stage_ldm`` writes what the CLI's sampling and measure modes read on an
LDM run: the pipeline in the HF layout and an ``args.json``, as the JAX
package's ``examples/stage_fake_ldm.py`` does (there at quarter scale).
"""

from __future__ import annotations

import json
import math
import os

import torch

from baddiffusion_tpu_torch.device import DeviceLike
from baddiffusion_tpu_torch.models.unet2d import UNet2DConfig, UNet2DModel
from baddiffusion_tpu_torch.models.vae import VQModel, VQModelConfig
from baddiffusion_tpu_torch.pipelines.ldm import LDMPipeline
from baddiffusion_tpu_torch.schedulers import DDIMConfig, DDIMScheduler

LDM_CELEBA_HQ_256_UNET = UNet2DConfig(
    sample_size=64,
    in_channels=3,
    out_channels=3,
    block_out_channels=(224, 448, 672, 896),
    layers_per_block=2,
    down_block_types=("DownBlock2D", "AttnDownBlock2D", "AttnDownBlock2D", "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "AttnUpBlock2D", "AttnUpBlock2D", "UpBlock2D"),
    attention_head_dim=32,
    norm_num_groups=32,
)
LDM_CELEBA_HQ_256_VQ = VQModelConfig(
    sample_size=256,
    in_channels=3,
    out_channels=3,
    block_out_channels=(128, 256, 512),
    down_block_types=("DownEncoderBlock2D",) * 3,
    up_block_types=("UpDecoderBlock2D",) * 3,
    layers_per_block=2,
    latent_channels=3,
    num_vq_embeddings=8192,
    norm_num_groups=32,
)
LDM_CELEBA_HQ_256_SCHEDULER = DDIMConfig(
    num_train_timesteps=1000, beta_start=0.0015, beta_end=0.0195, beta_schedule="scaled_linear", clip_sample=False,
)

NCSNPP_CELEBA_HQ_256 = UNet2DConfig(
    sample_size=256,
    in_channels=3,
    out_channels=3,
    block_out_channels=(128, 128, 256, 256, 256, 256, 256),
    layers_per_block=2,
    down_block_types=("SkipDownBlock2D",) * 4 + ("AttnSkipDownBlock2D",) + ("SkipDownBlock2D",) * 2,
    up_block_types=("SkipUpBlock2D",) * 2 + ("AttnSkipUpBlock2D",) + ("SkipUpBlock2D",) * 4,
    time_embedding_type="fourier",
    mid_block_scale_factor=math.sqrt(2.0),
)

DDPM_CIFAR10_32 = UNet2DConfig(
    sample_size=32,
    in_channels=3,
    out_channels=3,
    center_input_sample=False,
    time_embedding_type="positional",
    freq_shift=1,
    flip_sin_to_cos=False,
    down_block_types=("DownBlock2D", "AttnDownBlock2D", "DownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "UpBlock2D", "AttnUpBlock2D", "UpBlock2D"),
    block_out_channels=(128, 256, 256, 256),
    layers_per_block=2,
    mid_block_scale_factor=1,
    downsample_padding=0,
    act_fn="silu",
    attention_head_dim=None,
    norm_num_groups=32,
    norm_eps=1e-6,
)
DDPM_EMA_CELEBAHQ_256 = UNet2DConfig(
    sample_size=256,
    in_channels=3,
    out_channels=3,
    center_input_sample=False,
    time_embedding_type="positional",
    freq_shift=1,
    flip_sin_to_cos=False,
    down_block_types=("DownBlock2D", "DownBlock2D", "DownBlock2D", "DownBlock2D", "AttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "AttnUpBlock2D", "UpBlock2D", "UpBlock2D", "UpBlock2D", "UpBlock2D"),
    block_out_channels=(128, 128, 256, 256, 512, 512),
    layers_per_block=2,
    mid_block_scale_factor=1,
    downsample_padding=0,
    act_fn="silu",
    attention_head_dim=None,
    norm_num_groups=32,
    norm_eps=1e-6,
)


def stage_ldm(
    out_dir: str,
    unet_config: UNet2DConfig = LDM_CELEBA_HQ_256_UNET,
    vq_config: VQModelConfig = LDM_CELEBA_HQ_256_VQ,
    scheduler_config: DDIMConfig = LDM_CELEBA_HQ_256_SCHEDULER,
    dataset: str = "FAKE",
    seed: int = 0,
    device: DeviceLike = None,
    **run_args,
) -> LDMPipeline:
    """Write a seeded LDM pipeline (VQ-VAE from ``seed``, UNet from ``seed +
    1``) into ``out_dir`` in the HF layout, with an ``args.json`` naming
    ``dataset`` at the VQ-VAE's image size (and ``run_args``), so that
    ``--mode sampling|measure --ckpt out_dir`` reloads it like a trained run.
    Returns the pipeline, on ``device``."""
    vq = VQModel(vq_config, device=device, generator=torch.Generator().manual_seed(seed))
    unet = UNet2DModel(unet_config, device=device, generator=torch.Generator().manual_seed(seed + 1))
    pipe = LDMPipeline(vq, unet, DDIMScheduler(scheduler_config), device=device)
    pipe.save_pretrained(out_dir)
    args = {"mode": "train", "dataset": dataset, "batch": 16, "epoch": 1, "ckpt": "LDM-SYNTH", "trigger": "BOX_14",
            "target": "CORNER", "poison_rate": 0.1, "overwrite": True, "image_size": vq_config.sample_size}
    args.update(run_args)
    with open(os.path.join(out_dir, "args.json"), "w") as f:
        json.dump(args, f, indent=2)
    return pipe

