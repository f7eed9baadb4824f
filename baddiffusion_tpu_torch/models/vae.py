"""VQ-VAE and KL-VAE of the latent-diffusion path, NHWC (port of
``baddiffusion_tpu/models/vae.py``).

``VQModel``: encoder → quant_conv → ``VectorQuantizer`` (nearest codebook
row, straight-through) → post_quant_conv → decoder; ``encode`` is the span
``vq.encode``, ``decode`` the span ``vq.decode`` holding ``vq.quantize``.
``AutoencoderKL``: the same encoder and decoder around a diagonal gaussian
posterior. The encoder and decoder are temb-free blocks with GroupNorm eps
1e-6, a downsample without padding, and a one-head mid-block attention
(``[B, 1, H·W, C]``: at LDM-CELEBA-HQ-256's 64x64 latent, K3 at T = 4096,
D = 512). Every GroupNorm that a SiLU follows, ``conv_norm_out`` included,
goes through the fused kernel (K1) on the card.

As ``UNet2DModel``: the model is made on ``device`` (CUDA unless the caller
asks otherwise) from a seeded CPU generator, its parameters stay f32 and it
computes in ``dtype``; attribute names give the HF-0.16 state-dict keys
(``quantize.embedding.weight``, ...), so converted weights load with
``strict=True``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import torch
from torch import nn

from baddiffusion_tpu_torch.device import DeviceLike, resolve_device
from baddiffusion_tpu_torch.models.blocks import DownEncoderBlock2D, UNetMidBlock2D, UpDecoderBlock2D
from baddiffusion_tpu_torch.models.resnet import Conv2d, GroupNorm
from baddiffusion_tpu_torch.models.unet2d import MODEL_CONFIG_NAME, init_weights_
from baddiffusion_tpu_torch.ops import vq_nearest
from baddiffusion_tpu_torch.utils.profiling import span

VAE_EPS = 1e-6


class Encoder(nn.Module):
    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 down_block_types: Tuple[str, ...] = ("DownEncoderBlock2D",),
                 block_out_channels: Tuple[int, ...] = (64,), layers_per_block: int = 2, norm_num_groups: int = 32,
                 double_z: bool = True):
        super().__init__()
        self.conv_in = Conv2d(in_channels, block_out_channels[0], 3, padding=1)
        blocks = []
        output_channel = block_out_channels[0]
        for i, block_type in enumerate(down_block_types):
            input_channel, output_channel = output_channel, block_out_channels[i]
            blocks.append(DownEncoderBlock2D(
                input_channel, output_channel, num_layers=layers_per_block, resnet_eps=VAE_EPS,
                resnet_groups=norm_num_groups, add_downsample=i != len(block_out_channels) - 1,
                downsample_padding=0, add_attention=block_type.startswith("Attn"),
            ))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = UNetMidBlock2D(block_out_channels[-1], temb_channels=None, resnet_eps=VAE_EPS,
                                        resnet_groups=norm_num_groups, attn_num_head_channels=None)
        self.conv_norm_out = GroupNorm(norm_num_groups, block_out_channels[-1], VAE_EPS, silu=True)
        self.conv_out = Conv2d(block_out_channels[-1], 2 * out_channels if double_z else out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(self.mid_block(x)))


class Decoder(nn.Module):
    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 up_block_types: Tuple[str, ...] = ("UpDecoderBlock2D",),
                 block_out_channels: Tuple[int, ...] = (64,), layers_per_block: int = 2, norm_num_groups: int = 32):
        super().__init__()
        self.conv_in = Conv2d(in_channels, block_out_channels[-1], 3, padding=1)
        self.mid_block = UNetMidBlock2D(block_out_channels[-1], temb_channels=None, resnet_eps=VAE_EPS,
                                        resnet_groups=norm_num_groups, attn_num_head_channels=None)
        reversed_channels = list(reversed(block_out_channels))
        blocks = []
        output_channel = reversed_channels[0]
        for i, block_type in enumerate(up_block_types):
            input_channel, output_channel = output_channel, reversed_channels[i]
            blocks.append(UpDecoderBlock2D(
                input_channel, output_channel, num_layers=layers_per_block + 1, resnet_eps=VAE_EPS,
                resnet_groups=norm_num_groups, add_upsample=i != len(block_out_channels) - 1,
                add_attention=block_type.startswith("Attn"),
            ))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(norm_num_groups, block_out_channels[0], VAE_EPS, silu=True)
        self.conv_out = Conv2d(block_out_channels[0], out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(x))


class VectorQuantizer(nn.Module):
    """Nearest codebook row of each ``vq_embed_dim`` vector of z, in f32
    (``ops.vq_nearest``: a kernel on the card that holds no ``[N, K]``
    distance matrix; on the CPU its plain twin, the expanded L2
    ‖z‖² + ‖e‖² − 2 z·e); the codebook rows come back through the
    straight-through form z + (z_q − z), detached, as the JAX module computes
    them. Returns (z_q in z's dtype, indices ``z.shape[:-1]``)."""

    def __init__(self, n_e: int, vq_embed_dim: int):
        super().__init__()
        self.vq_embed_dim = vq_embed_dim
        self.embedding = nn.Embedding(n_e, vq_embed_dim)

    def forward(self, z: torch.Tensor):
        zf = z.float()
        idx, z_q = vq_nearest(zf.reshape(-1, self.vq_embed_dim).contiguous(), self.embedding.weight.float())
        z_q = z_q.reshape(zf.shape)
        return (zf + (z_q - zf).detach()).to(z.dtype), idx.reshape(z.shape[:-1])


def _config_json(config, class_name: str) -> dict:
    payload = {"_class_name": class_name, "_diffusers_version": "0.16.0.dev0"}
    payload.update({k: (list(v) if isinstance(v, tuple) else v) for k, v in dataclasses.asdict(config).items()})
    return payload


def _load_config(cls, path: str, subfolder: Optional[str]):
    if subfolder:
        path = os.path.join(path, subfolder)
    if os.path.isdir(path):
        path = os.path.join(path, MODEL_CONFIG_NAME)
    with open(path) as f:
        payload = json.load(f)
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in payload.items() if k in fields})


@dataclasses.dataclass(frozen=True)
class VQModelConfig:
    """The HF VQModel ``config.json`` surface, as in the JAX package."""

    in_channels: int = 3
    out_channels: int = 3
    down_block_types: Tuple[str, ...] = ("DownEncoderBlock2D",)
    up_block_types: Tuple[str, ...] = ("UpDecoderBlock2D",)
    block_out_channels: Tuple[int, ...] = (64,)
    layers_per_block: int = 1
    latent_channels: int = 3
    sample_size: int = 32
    num_vq_embeddings: int = 256
    norm_num_groups: int = 32
    vq_embed_dim: Optional[int] = None
    scaling_factor: float = 0.18215

    def __post_init__(self):
        for f in ("down_block_types", "up_block_types", "block_out_channels"):
            object.__setattr__(self, f, tuple(getattr(self, f)))

    def save(self, save_directory: str) -> None:
        os.makedirs(save_directory, exist_ok=True)
        with open(os.path.join(save_directory, MODEL_CONFIG_NAME), "w") as f:
            json.dump(_config_json(self, "VQModel"), f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str, subfolder: Optional[str] = None) -> "VQModelConfig":
        return _load_config(cls, path, subfolder)


class _Autoencoder(nn.Module):
    """Built on the meta device, moved to ``device`` and initialised from
    ``generator`` (default: a CPU generator seeded 0), as ``UNet2DModel``."""

    def __init__(self, config, device: DeviceLike, generator: Optional[torch.Generator], dtype: torch.dtype):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.dtype = dtype
        with torch.device("meta"):
            self._build(config)
        self.to_empty(device=device)
        init_weights_(self, generator if generator is not None else torch.Generator().manual_seed(0))
        self.to(memory_format=torch.channels_last)
        self.eval()

    def _coders(self, cfg, double_z: bool) -> None:
        self.encoder = Encoder(cfg.in_channels, cfg.latent_channels, cfg.down_block_types, cfg.block_out_channels,
                               cfg.layers_per_block, cfg.norm_num_groups, double_z=double_z)
        self.decoder = Decoder(cfg.latent_channels, cfg.out_channels, cfg.up_block_types, cfg.block_out_channels,
                               cfg.layers_per_block, cfg.norm_num_groups)


class VQModel(_Autoencoder):
    """``encode(x [B, H, W, C])`` → latents ``[B, H/f, W/f, vq_dim]`` (not
    quantized); ``decode(h, force_not_quantize=False)`` → images; both in
    ``dtype``."""

    def __init__(self, config: VQModelConfig = VQModelConfig(), device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None, dtype: torch.dtype = torch.float32):
        super().__init__(config, device, generator, dtype)

    def _build(self, cfg: VQModelConfig) -> None:
        vq_dim = cfg.vq_embed_dim or cfg.latent_channels
        self._coders(cfg, double_z=False)
        self.quant_conv = Conv2d(cfg.latent_channels, vq_dim, 1)
        self.quantize = VectorQuantizer(cfg.num_vq_embeddings, vq_dim)
        self.post_quant_conv = Conv2d(vq_dim, cfg.latent_channels, 1)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        with span("vq.encode"):
            return self.quant_conv(self.encoder(x.to(self.dtype)))

    def decode(self, h: torch.Tensor, force_not_quantize: bool = False) -> torch.Tensor:
        with span("vq.decode"):
            h = h.to(self.dtype)
            if not force_not_quantize:
                with span("vq.quantize"):
                    h, _ = self.quantize(h)
            return self.decoder(self.post_quant_conv(h))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))


@dataclasses.dataclass(frozen=True)
class AutoencoderKLConfig:
    in_channels: int = 3
    out_channels: int = 3
    down_block_types: Tuple[str, ...] = ("DownEncoderBlock2D",)
    up_block_types: Tuple[str, ...] = ("UpDecoderBlock2D",)
    block_out_channels: Tuple[int, ...] = (64,)
    layers_per_block: int = 1
    latent_channels: int = 4
    sample_size: int = 32
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215

    def __post_init__(self):
        for f in ("down_block_types", "up_block_types", "block_out_channels"):
            object.__setattr__(self, f, tuple(getattr(self, f)))


class AutoencoderKL(_Autoencoder):
    """``encode`` → (mean, logvar clipped to [−30, 20]) of the diagonal
    gaussian posterior; ``decode(z)``; ``forward(x, noise=None)`` decodes the
    mean, or mean + exp(logvar / 2)·noise."""

    def __init__(self, config: AutoencoderKLConfig = AutoencoderKLConfig(), device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None, dtype: torch.dtype = torch.float32):
        super().__init__(config, device, generator, dtype)

    def _build(self, cfg: AutoencoderKLConfig) -> None:
        self._coders(cfg, double_z=True)
        self.quant_conv = Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        self.post_quant_conv = Conv2d(cfg.latent_channels, cfg.latent_channels, 1)

    def encode(self, x: torch.Tensor):
        mean, logvar = self.quant_conv(self.encoder(x.to(self.dtype))).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z.to(self.dtype)))

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        mean, logvar = self.encode(x)
        return self.decode(mean if noise is None else mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype))
