"""Timestep embeddings (port of ``baddiffusion_tpu/models/embeddings.py``).

The sinusoid is computed in f32 from the integer timesteps; the UNet casts it
to its compute dtype before the MLP, as the JAX model does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from baddiffusion_tpu_torch.models.resnet import Linear


def get_timestep_embedding(
    timesteps: torch.Tensor,
    embedding_dim: int,
    flip_sin_to_cos: bool = False,
    downscale_freq_shift: float = 1.0,
    scale: float = 1.0,
    max_period: int = 10000,
) -> torch.Tensor:
    """Sinusoidal embeddings ``[B, embedding_dim]`` in f32."""
    if timesteps.dim() != 1:
        raise ValueError("timesteps should be a 1-D tensor of shape [batch]")
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = torch.exp(exponent)
    emb = timesteps.float()[:, None] * emb[None, :]
    emb = scale * emb
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class Timesteps(nn.Module):
    """Parameter-free sinusoidal projection."""

    def __init__(self, num_channels: int, flip_sin_to_cos: bool = False, downscale_freq_shift: float = 1.0):
        super().__init__()
        self.num_channels = num_channels
        self.flip_sin_to_cos = flip_sin_to_cos
        self.downscale_freq_shift = downscale_freq_shift

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        return get_timestep_embedding(
            timesteps,
            self.num_channels,
            flip_sin_to_cos=self.flip_sin_to_cos,
            downscale_freq_shift=self.downscale_freq_shift,
        )


class TimestepEmbedding(nn.Module):
    """linear_1 → SiLU → linear_2 MLP."""

    def __init__(self, in_channels: int, time_embed_dim: int, out_dim: Optional[int] = None):
        super().__init__()
        self.linear_1 = Linear(in_channels, time_embed_dim)
        self.linear_2 = Linear(time_embed_dim, out_dim or time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))


class GaussianFourierProjection(nn.Module):
    """Random-feature time embedding (``time_embedding_type='fourier'``). The
    projection weight is a fixed, untrained gaussian draw: the UNet's seeded
    init fills it with ``scale``·N(0, 1)."""

    def __init__(self, embedding_size: int = 256, scale: float = 1.0, log: bool = True, flip_sin_to_cos: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(embedding_size), requires_grad=False)
        self.scale = scale
        self.log = log
        self.flip_sin_to_cos = flip_sin_to_cos

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.log:
            x = torch.log(x)
        x_proj = x.float()[:, None] * self.weight.float()[None, :] * 2 * math.pi
        if self.flip_sin_to_cos:
            return torch.cat([torch.cos(x_proj), torch.sin(x_proj)], dim=-1)
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)
