"""UNet2DModel, the ε-predictor (port of ``baddiffusion_tpu/models/unet2d.py``).

Public layout is the JAX package's: ``forward(sample[B, H, W, C], t)`` returns
``[B, H, W, C_out]`` in f32. ``dtype`` is the compute dtype, as the flax
module's: parameters stay in their own dtype (f32), activations run in
``dtype``, and the convs and dense layers cast their weights to it per call
(``compute_copy`` makes a copy whose weights are cast once, for sampling).
Inside, activations stay NHWC, which is NCHW in ``torch.channels_last``
memory for the convs (models/resnet.py), and conv weights are kept in
channels_last too so cuDNN never converts them per call.
Module attribute names give the HF-0.16 state-dict keys, so converted weights
(io/hf.py) load with ``strict=True``.

Every config of the JAX model builds: the DDPM blocks, the NCSN++ FIR skip
blocks (``SkipDownBlock2D``/``SkipUpBlock2D`` and their Attn variants, with
the image-space skip sample carried down and restarted on the way up) and
the class embeddings (``num_class_embeds`` → an ``Embedding``,
``class_embed_type`` ``"timestep"`` or ``"identity"``; ``forward`` then takes
``class_labels``).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Optional, Tuple

import torch
from torch import nn

from baddiffusion_tpu_torch.device import DeviceLike, resolve_device
from baddiffusion_tpu_torch.models.blocks import (
    AttnDownBlock2D,
    AttnSkipDownBlock2D,
    AttnSkipUpBlock2D,
    AttnUpBlock2D,
    DownBlock2D,
    SkipDownBlock2D,
    SkipUpBlock2D,
    UNetMidBlock2D,
    UpBlock2D,
)
from baddiffusion_tpu_torch.models.embeddings import GaussianFourierProjection, TimestepEmbedding, Timesteps
from baddiffusion_tpu_torch.models.resnet import Conv2d, GroupNorm, Linear
from baddiffusion_tpu_torch.utils.profiling import span, timed

MODEL_CONFIG_NAME = "config.json"

_DOWN_BLOCKS = {"DownBlock2D": DownBlock2D, "AttnDownBlock2D": AttnDownBlock2D}
_UP_BLOCKS = {"UpBlock2D": UpBlock2D, "AttnUpBlock2D": AttnUpBlock2D}
# the NCSN++ blocks: no resnet_groups (theirs follow the channels), and a skip sample in and out
_SKIP_DOWN_BLOCKS = {"SkipDownBlock2D": SkipDownBlock2D, "AttnSkipDownBlock2D": AttnSkipDownBlock2D}
_SKIP_UP_BLOCKS = {"SkipUpBlock2D": SkipUpBlock2D, "AttnSkipUpBlock2D": AttnSkipUpBlock2D}


@dataclasses.dataclass(frozen=True)
class UNet2DConfig:
    """The HF UNet2DModel ``config.json`` surface, field for field as in the
    JAX package."""

    sample_size: Optional[int] = None
    in_channels: int = 3
    out_channels: int = 3
    center_input_sample: bool = False
    time_embedding_type: str = "positional"
    freq_shift: int = 0
    flip_sin_to_cos: bool = True
    down_block_types: Tuple[str, ...] = (
        "DownBlock2D",
        "AttnDownBlock2D",
        "AttnDownBlock2D",
        "AttnDownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "AttnUpBlock2D",
        "AttnUpBlock2D",
        "AttnUpBlock2D",
        "UpBlock2D",
    )
    block_out_channels: Tuple[int, ...] = (224, 448, 672, 896)
    layers_per_block: int = 2
    mid_block_scale_factor: float = 1.0
    downsample_padding: int = 1
    act_fn: str = "silu"
    attention_head_dim: Optional[int] = 8
    norm_num_groups: Optional[int] = 32
    norm_eps: float = 1e-5
    resnet_time_scale_shift: str = "default"
    add_attention: bool = True
    class_embed_type: Optional[str] = None
    num_class_embeds: Optional[int] = None
    dropout: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "down_block_types", tuple(self.down_block_types))
        object.__setattr__(self, "up_block_types", tuple(self.up_block_types))
        object.__setattr__(self, "block_out_channels", tuple(self.block_out_channels))

    def save(self, save_directory: str) -> None:
        os.makedirs(save_directory, exist_ok=True)
        payload = {"_class_name": "UNet2DModel", "_diffusers_version": "0.16.0.dev0"}
        d = dataclasses.asdict(self)
        d.pop("dropout", None)  # not part of the HF config surface
        payload.update({k: (list(v) if isinstance(v, tuple) else v) for k, v in d.items()})
        with open(os.path.join(save_directory, MODEL_CONFIG_NAME), "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str, subfolder: Optional[str] = None) -> "UNet2DConfig":
        if subfolder:
            path = os.path.join(path, subfolder)
        if os.path.isdir(path):
            path = os.path.join(path, MODEL_CONFIG_NAME)
        with open(path) as f:
            payload = json.load(f)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in payload.items() if k in fields})


# scratch-model architecture used when no checkpoint is given:
# 128,128,256,256,512,512 with one AttnDown and one AttnUp block
DEFAULT_SCRATCH_CONFIG = UNet2DConfig(
    block_out_channels=(128, 128, 256, 256, 512, 512),
    down_block_types=(
        "DownBlock2D",
        "DownBlock2D",
        "DownBlock2D",
        "DownBlock2D",
        "AttnDownBlock2D",
        "DownBlock2D",
    ),
    up_block_types=(
        "UpBlock2D",
        "AttnUpBlock2D",
        "UpBlock2D",
        "UpBlock2D",
        "UpBlock2D",
        "UpBlock2D",
    ),
)


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """Deterministic init of every parameter from ``generator`` (a CPU
    generator, so the weights do not depend on the device): conv and linear
    weights N(0, 1/fan_in), biases 0, norm scales 1, the Fourier projection
    ``scale``·N(0, 1), embedding tables N(0, 1)."""
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            w = module.weight
            fan_in = w[0].numel()
            w.copy_(torch.randn(w.shape, generator=generator) * fan_in ** -0.5)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, GroupNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, GaussianFourierProjection):
            module.weight.copy_(torch.randn(module.weight.shape, generator=generator) * module.scale)
        elif isinstance(module, nn.Embedding):
            module.weight.copy_(torch.randn(module.weight.shape, generator=generator))


class UNet2DModel(nn.Module):
    """The UNet on ``device`` (CUDA unless the caller asks otherwise; raises
    without a GPU), initialised from ``generator`` (default: a CPU generator
    seeded with 0), computing in ``dtype`` with f32 parameters."""

    def __init__(self, config: UNet2DConfig = DEFAULT_SCRATCH_CONFIG, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        unknown = [t for t in config.down_block_types if t not in _DOWN_BLOCKS and t not in _SKIP_DOWN_BLOCKS]
        unknown += [t for t in config.up_block_types if t not in _UP_BLOCKS and t not in _SKIP_UP_BLOCKS]
        if unknown:
            raise NotImplementedError(f"blocks {unknown}")
        if config.class_embed_type not in (None, "timestep", "identity"):
            raise NotImplementedError(f"class_embed_type {config.class_embed_type!r}")
        self.config = config
        with timed("unet.init"):
            with torch.device("meta"):  # build without allocating; init below
                self._build(config)
            self.to_empty(device=device)
            init_weights_(self, generator if generator is not None else torch.Generator().manual_seed(0))
            self.to(memory_format=torch.channels_last)
        self.eval()

    def _build(self, cfg: UNet2DConfig) -> None:
        c0 = cfg.block_out_channels[0]
        time_embed_dim = c0 * 4
        if cfg.time_embedding_type == "fourier":
            self.time_proj = GaussianFourierProjection(embedding_size=c0, scale=16.0)
            timestep_input_dim = 2 * c0
        else:
            self.time_proj = Timesteps(c0, flip_sin_to_cos=cfg.flip_sin_to_cos, downscale_freq_shift=cfg.freq_shift)
            timestep_input_dim = c0
        self.time_embedding = TimestepEmbedding(timestep_input_dim, time_embed_dim)
        if cfg.class_embed_type is None and cfg.num_class_embeds is not None:
            self.class_embedding = nn.Embedding(cfg.num_class_embeds, time_embed_dim)
        elif cfg.class_embed_type == "timestep":
            self.class_proj = Timesteps(c0, flip_sin_to_cos=cfg.flip_sin_to_cos, downscale_freq_shift=cfg.freq_shift)
            self.class_embedding = TimestepEmbedding(c0, time_embed_dim)
        self.conv_in = Conv2d(cfg.in_channels, c0, 3, padding=1)

        n_levels = len(cfg.block_out_channels)
        down = []
        output_channel = c0
        for i, block_type in enumerate(cfg.down_block_types):
            input_channel, output_channel = output_channel, cfg.block_out_channels[i]
            kwargs = dict(
                in_channels=input_channel, out_channels=output_channel, temb_channels=time_embed_dim,
                num_layers=cfg.layers_per_block, resnet_eps=cfg.norm_eps,
                resnet_time_scale_shift=cfg.resnet_time_scale_shift, add_downsample=i != n_levels - 1,
                dropout=cfg.dropout, attn_num_head_channels=cfg.attention_head_dim,
            )
            if block_type in _SKIP_DOWN_BLOCKS:
                down.append(_SKIP_DOWN_BLOCKS[block_type](skip_channels=cfg.in_channels, **kwargs))
            else:
                down.append(_DOWN_BLOCKS[block_type](resnet_groups=cfg.norm_num_groups,
                                                     downsample_padding=cfg.downsample_padding, **kwargs))
        self.down_blocks = nn.ModuleList(down)

        self.mid_block = UNetMidBlock2D(
            in_channels=cfg.block_out_channels[-1], temb_channels=time_embed_dim, resnet_eps=cfg.norm_eps,
            output_scale_factor=cfg.mid_block_scale_factor, resnet_time_scale_shift=cfg.resnet_time_scale_shift,
            attn_num_head_channels=cfg.attention_head_dim, resnet_groups=cfg.norm_num_groups,
            add_attention=cfg.add_attention, dropout=cfg.dropout,
        )

        up = []
        reversed_channels = list(reversed(cfg.block_out_channels))
        output_channel = reversed_channels[0]
        for i, block_type in enumerate(cfg.up_block_types):
            prev_output_channel, output_channel = output_channel, reversed_channels[i]
            kwargs = dict(
                in_channels=reversed_channels[min(i + 1, n_levels - 1)], prev_output_channel=prev_output_channel,
                out_channels=output_channel, temb_channels=time_embed_dim, num_layers=cfg.layers_per_block + 1,
                resnet_eps=cfg.norm_eps, resnet_time_scale_shift=cfg.resnet_time_scale_shift,
                add_upsample=i != n_levels - 1, dropout=cfg.dropout, attn_num_head_channels=cfg.attention_head_dim,
            )
            if block_type in _SKIP_UP_BLOCKS:
                up.append(_SKIP_UP_BLOCKS[block_type](skip_channels=cfg.in_channels, **kwargs))
            else:
                up.append(_UP_BLOCKS[block_type](resnet_groups=cfg.norm_num_groups, **kwargs))
        self.up_blocks = nn.ModuleList(up)

        groups_out = cfg.norm_num_groups if cfg.norm_num_groups is not None else min(c0 // 4, 32)
        self.conv_norm_out = GroupNorm(groups_out, c0, cfg.norm_eps, silu=True)
        self.conv_out = Conv2d(c0, cfg.out_channels, 3, padding=1)

    def compute_copy(self, dtype: torch.dtype) -> "UNet2DModel":
        """A copy that computes in ``dtype`` with its conv and dense weights
        (and dense biases) cast to it once, so a forward pays no weight casts;
        the GroupNorm affines, the conv biases (added in f32 by
        ``ops.bias_shift``) and the Fourier projection stay f32."""
        twin = copy.deepcopy(self)
        for module in twin.modules():
            if isinstance(module, Linear):
                module.to(dtype)
            elif isinstance(module, Conv2d):
                module.weight.data = module.weight.data.to(dtype)
        twin.dtype = dtype
        return twin

    def forward(self, sample: torch.Tensor, timesteps, class_labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sample: ``[B, H, W, C]``; timesteps: scalar or ``[B]``;
        class_labels: ``[B]`` class ids (``num_class_embeds``) or timesteps
        (``"timestep"``), or ``[B, 4·C0]`` embeddings (``"identity"``).
        Computes in ``self.dtype``; returns f32. Under a recording profiler
        the call is the span ``unet.forward``, holding ``unet.embed``
        (with ``conv_in``), ``unet.down.<i>``, ``unet.mid``, ``unet.up.<i>``
        and ``unet.out``; the construction is counted as ``unet.init``
        (``utils/profiling``)."""
        with span("unet.forward"):
            return self._forward(sample, timesteps, class_labels)

    def _forward(self, sample, timesteps, class_labels):
        cfg = self.config
        dtype = self.dtype
        with span("unet.embed"):
            if cfg.center_input_sample:
                sample = 2.0 * sample - 1.0
            timesteps = torch.as_tensor(timesteps, device=sample.device)
            if timesteps.dim() == 0:
                timesteps = timesteps.expand(sample.shape[0])

            emb = self.time_embedding(self.time_proj(timesteps).to(dtype))
            if cfg.class_embed_type is None and cfg.num_class_embeds is not None:
                emb = emb + self.class_embedding(class_labels.long()).to(dtype)
            elif cfg.class_embed_type == "timestep":
                emb = emb + self.class_embedding(self.class_proj(class_labels).to(dtype))
            elif cfg.class_embed_type == "identity":
                emb = emb + class_labels.to(dtype)

            skip_sample = sample
            sample = self.conv_in(sample.to(dtype))

        down_block_res_samples = (sample,)
        for i, block in enumerate(self.down_blocks):
            with span(f"unet.down.{i}"):
                if isinstance(block, SkipDownBlock2D):
                    sample, res_samples, skip_sample = block(sample, emb, skip_sample)
                else:
                    sample, res_samples = block(sample, emb)
            down_block_res_samples += res_samples

        with span("unet.mid"):
            sample = self.mid_block(sample, emb)

        # the skip chain restarts at None on the way up
        skip_sample = None
        for i, block in enumerate(self.up_blocks):
            n_res = len(block.resnets)
            res_samples = down_block_res_samples[-n_res:]
            down_block_res_samples = down_block_res_samples[:-n_res]
            with span(f"unet.up.{i}"):
                if isinstance(block, SkipUpBlock2D):
                    sample, skip_sample = block(sample, res_samples, emb, skip_sample)
                else:
                    sample = block(sample, res_samples, emb)

        with span("unet.out"):
            sample = self.conv_out(self.conv_norm_out(sample))
            if skip_sample is not None:
                sample = sample + skip_sample
            if cfg.time_embedding_type == "fourier":
                sample = sample / timesteps.reshape(-1, 1, 1, 1).to(sample.dtype)
            return sample.float()
