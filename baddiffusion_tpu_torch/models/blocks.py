"""UNet2D and VAE building blocks, NHWC (port of
``baddiffusion_tpu/models/blocks.py``): DownBlock2D, AttnDownBlock2D,
UpBlock2D, AttnUpBlock2D and UNetMidBlock2D; the NCSN++ FIR skip blocks
SkipDownBlock2D and SkipUpBlock2D (and their Attn variants); and the VAE's
temb-free DownEncoderBlock2D and UpDecoderBlock2D.

Quirk kept for checkpoint parity: the skip blocks' GroupNorm group counts
(``min(ch // 4, 32)``, including AttnSkipUpBlock2D's literal
``min(in + skip // 4, 32)``) are the JAX package's, which are diffusers'.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from baddiffusion_tpu_torch.models.attention import AttentionBlock
from baddiffusion_tpu_torch.models.resnet import (
    Conv2d,
    Downsample2D,
    FirDownsample2D,
    FirUpsample2D,
    GroupNorm,
    ResnetBlock2D,
    Upsample2D,
)

SQRT2 = math.sqrt(2.0)


def _resnet(in_channels, out_channels, temb_channels, eps, groups, time_scale_shift, dropout, output_scale_factor=1.0):
    return ResnetBlock2D(
        in_channels=in_channels,
        out_channels=out_channels,
        temb_channels=temb_channels,
        eps=eps,
        groups=groups,
        time_embedding_norm=time_scale_shift,
        output_scale_factor=output_scale_factor,
        dropout=dropout,
    )


class DownBlock2D(nn.Module):
    """Resnets (each optionally followed by attention), then a downsample.
    Returns the hidden state and the per-layer outputs the up path consumes."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        temb_channels: int,
        num_layers: int = 1,
        resnet_eps: float = 1e-6,
        resnet_time_scale_shift: str = "default",
        resnet_groups: int = 32,
        add_downsample: bool = True,
        downsample_padding: int = 1,
        dropout: float = 0.0,
        add_attention: bool = False,
        attn_num_head_channels: Optional[int] = 1,
    ):
        super().__init__()
        self.resnets = nn.ModuleList(
            _resnet(in_channels if i == 0 else out_channels, out_channels, temb_channels, resnet_eps,
                    resnet_groups, resnet_time_scale_shift, dropout)
            for i in range(num_layers)
        )
        if add_attention:
            self.attentions = nn.ModuleList(
                AttentionBlock(out_channels, num_head_channels=attn_num_head_channels, eps=resnet_eps,
                               norm_num_groups=resnet_groups)
                for _ in range(num_layers)
            )
        else:
            self.attentions = None
        self.downsamplers = (
            nn.ModuleList([Downsample2D(out_channels, padding=downsample_padding)]) if add_downsample else None
        )

    def forward(self, hidden: torch.Tensor, temb: torch.Tensor) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        output_states = ()
        for i, resnet in enumerate(self.resnets):
            hidden = resnet(hidden, temb)
            if self.attentions is not None:
                hidden = self.attentions[i](hidden)
            output_states += (hidden,)
        if self.downsamplers is not None:
            hidden = self.downsamplers[0](hidden)
            output_states += (hidden,)
        return hidden, output_states


class AttnDownBlock2D(DownBlock2D):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, add_attention=True, **kwargs)


class UpBlock2D(nn.Module):
    """Each resnet takes the hidden state concatenated (on channels) with one
    down-path output, last first; optional attention after each; then an
    upsample."""

    def __init__(
        self,
        in_channels: int,
        prev_output_channel: int,
        out_channels: int,
        temb_channels: int,
        num_layers: int = 1,
        resnet_eps: float = 1e-6,
        resnet_time_scale_shift: str = "default",
        resnet_groups: int = 32,
        add_upsample: bool = True,
        dropout: float = 0.0,
        add_attention: bool = False,
        attn_num_head_channels: Optional[int] = 1,
    ):
        super().__init__()
        resnets = []
        for i in range(num_layers):
            res_skip_channels = in_channels if i == num_layers - 1 else out_channels
            resnet_in_channels = prev_output_channel if i == 0 else out_channels
            resnets.append(_resnet(resnet_in_channels + res_skip_channels, out_channels, temb_channels, resnet_eps,
                                   resnet_groups, resnet_time_scale_shift, dropout))
        self.resnets = nn.ModuleList(resnets)
        if add_attention:
            self.attentions = nn.ModuleList(
                AttentionBlock(out_channels, num_head_channels=attn_num_head_channels, eps=resnet_eps,
                               norm_num_groups=resnet_groups)
                for _ in range(num_layers)
            )
        else:
            self.attentions = None
        self.upsamplers = (
            nn.ModuleList([Upsample2D(out_channels)]) if add_upsample else None
        )

    def forward(self, hidden: torch.Tensor, res_hidden_states: Sequence[torch.Tensor], temb: torch.Tensor) -> torch.Tensor:
        res_hidden_states = list(res_hidden_states)
        for i, resnet in enumerate(self.resnets):
            hidden = torch.cat([hidden, res_hidden_states.pop()], dim=-1)
            hidden = resnet(hidden, temb)
            if self.attentions is not None:
                hidden = self.attentions[i](hidden)
        if self.upsamplers is not None:
            hidden = self.upsamplers[0](hidden)
        return hidden


class AttnUpBlock2D(UpBlock2D):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, add_attention=True, **kwargs)


class UNetMidBlock2D(nn.Module):
    """resnet → (attention → resnet) × num_layers. ``temb_channels=None``
    makes the VAE's temb-free form; ``resnet_groups=None`` takes
    ``min(in_channels // 4, 32)`` groups."""

    def __init__(
        self,
        in_channels: int,
        temb_channels: Optional[int],
        num_layers: int = 1,
        resnet_eps: float = 1e-6,
        resnet_time_scale_shift: str = "default",
        resnet_groups: Optional[int] = 32,
        add_attention: bool = True,
        attn_num_head_channels: Optional[int] = 1,
        output_scale_factor: float = 1.0,
        dropout: float = 0.0,
    ):
        super().__init__()
        groups = resnet_groups if resnet_groups is not None else min(in_channels // 4, 32)
        self.resnets = nn.ModuleList(
            _resnet(in_channels, in_channels, temb_channels, resnet_eps, groups,
                    resnet_time_scale_shift, dropout, output_scale_factor)
            for _ in range(num_layers + 1)
        )
        self.attentions = nn.ModuleList(
            AttentionBlock(in_channels, num_head_channels=attn_num_head_channels,
                           rescale_output_factor=output_scale_factor, eps=resnet_eps, norm_num_groups=groups)
            for _ in range(num_layers if add_attention else 0)
        )

    def forward(self, hidden: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        hidden = self.resnets[0](hidden, temb)
        for i, resnet in enumerate(self.resnets[1:]):
            if len(self.attentions):
                hidden = self.attentions[i](hidden)
            hidden = resnet(hidden, temb)
        return hidden


class SkipDownBlock2D(nn.Module):
    """The NCSN++ encoder block: resnets (each followed by attention with
    ``add_attention``), then a FIR-downsampling resnet, while the image-space
    skip sample is FIR-downsampled and added in through a 1x1 conv. Returns
    (hidden, the outputs the up path consumes, skip sample)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        temb_channels: int,
        num_layers: int = 1,
        resnet_eps: float = 1e-6,
        resnet_time_scale_shift: str = "default",
        output_scale_factor: float = SQRT2,
        add_downsample: bool = True,
        dropout: float = 0.0,
        add_attention: bool = False,
        attn_num_head_channels: Optional[int] = 1,
        skip_channels: int = 3,
    ):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(in_channels if i == 0 else out_channels, out_channels, temb_channels,
                          groups=min((in_channels if i == 0 else out_channels) // 4, 32),
                          groups_out=min(out_channels // 4, 32), eps=resnet_eps,
                          time_embedding_norm=resnet_time_scale_shift, output_scale_factor=output_scale_factor,
                          dropout=dropout)
            for i in range(num_layers)
        )
        self.attentions = nn.ModuleList(
            AttentionBlock(out_channels, num_head_channels=attn_num_head_channels,
                           rescale_output_factor=output_scale_factor, eps=resnet_eps)
            for _ in range(num_layers if add_attention else 0)
        )
        if add_downsample:
            self.resnet_down = ResnetBlock2D(
                out_channels, out_channels, temb_channels, groups=min(out_channels // 4, 32), eps=resnet_eps,
                time_embedding_norm=resnet_time_scale_shift, output_scale_factor=output_scale_factor,
                dropout=dropout, use_in_shortcut=True, down=True, kernel="fir",
            )
            self.downsamplers = nn.ModuleList([FirDownsample2D(out_channels)])
            self.skip_conv = Conv2d(skip_channels, out_channels, 1)
        else:
            self.resnet_down = self.downsamplers = self.skip_conv = None

    def forward(self, hidden: torch.Tensor, temb: torch.Tensor, skip_sample: torch.Tensor):
        output_states = ()
        for i, resnet in enumerate(self.resnets):
            hidden = resnet(hidden, temb)
            if len(self.attentions):
                hidden = self.attentions[i](hidden)
            output_states += (hidden,)
        if self.resnet_down is not None:
            hidden = self.resnet_down(hidden, temb)
            # the FIR filter runs in the skip sample's dtype (the input's, f32), the 1x1 conv in the
            # block's, as flax's Conv casts its input: an f32 conv here would turn the rest of a bf16
            # UNet f32
            skip_sample = self.downsamplers[0](skip_sample)
            hidden = self.skip_conv(skip_sample.to(hidden.dtype)) + hidden
            output_states += (hidden,)
        return hidden, output_states, skip_sample


class AttnSkipDownBlock2D(SkipDownBlock2D):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, add_attention=True, **kwargs)


class SkipUpBlock2D(nn.Module):
    """The NCSN++ decoder block: resnets over the concatenated down-path
    outputs, one attention after them with ``add_attention``; the image-space
    skip sample is FIR-upsampled and, with ``add_upsample``, gets the block's
    output through GroupNorm → SiLU → 3x3 conv added before a FIR-upsampling
    resnet. Returns (hidden, skip sample); the skip sample of the first up
    block is None (then 0)."""

    def __init__(
        self,
        in_channels: int,
        prev_output_channel: int,
        out_channels: int,
        temb_channels: int,
        num_layers: int = 1,
        resnet_eps: float = 1e-6,
        resnet_time_scale_shift: str = "default",
        output_scale_factor: float = SQRT2,
        add_upsample: bool = True,
        dropout: float = 0.0,
        add_attention: bool = False,
        attn_num_head_channels: Optional[int] = 1,
        skip_channels: int = 3,
    ):
        super().__init__()
        resnets = []
        for i in range(num_layers):
            res_skip_channels = in_channels if i == num_layers - 1 else out_channels
            resnet_in_channels = prev_output_channel if i == 0 else out_channels
            # the Attn variant's group count misses its parentheses, as in diffusers
            groups_in = (min(resnet_in_channels + res_skip_channels // 4, 32) if add_attention
                         else min((resnet_in_channels + res_skip_channels) // 4, 32))
            resnets.append(ResnetBlock2D(
                resnet_in_channels + res_skip_channels, out_channels, temb_channels, groups=groups_in,
                groups_out=min(out_channels // 4, 32), eps=resnet_eps, time_embedding_norm=resnet_time_scale_shift,
                output_scale_factor=output_scale_factor, dropout=dropout,
            ))
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(
            [AttentionBlock(out_channels, num_head_channels=attn_num_head_channels,
                            rescale_output_factor=output_scale_factor, eps=resnet_eps)] if add_attention else []
        )
        self.upsampler = FirUpsample2D(skip_channels)
        if add_upsample:
            groups = min(out_channels // 4, 32)
            self.skip_norm = GroupNorm(groups, out_channels, resnet_eps, silu=True)
            self.skip_conv = Conv2d(out_channels, skip_channels, 3, padding=1)
            self.resnet_up = ResnetBlock2D(
                out_channels, out_channels, temb_channels, groups=groups, groups_out=groups, eps=resnet_eps,
                time_embedding_norm=resnet_time_scale_shift, output_scale_factor=output_scale_factor,
                dropout=dropout, use_in_shortcut=True, up=True, kernel="fir",
            )
        else:
            self.skip_norm = self.skip_conv = self.resnet_up = None

    def forward(self, hidden: torch.Tensor, res_hidden_states: Sequence[torch.Tensor], temb: torch.Tensor,
                skip_sample: Optional[torch.Tensor]):
        res_hidden_states = list(res_hidden_states)
        for resnet in self.resnets:
            hidden = resnet(torch.cat([hidden, res_hidden_states.pop()], dim=-1), temb)
        if len(self.attentions):
            hidden = self.attentions[0](hidden)
        skip_sample = 0 if skip_sample is None else self.upsampler(skip_sample)
        if self.resnet_up is not None:
            skip_sample = skip_sample + self.skip_conv(self.skip_norm(hidden))
            hidden = self.resnet_up(hidden, temb)
        return hidden, skip_sample


class AttnSkipUpBlock2D(SkipUpBlock2D):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, add_attention=True, **kwargs)


class DownEncoderBlock2D(nn.Module):
    """The VAE encoder's temb-free block: resnets (each optionally followed
    by attention), then a downsample."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        num_layers: int = 1,
        resnet_eps: float = 1e-6,
        resnet_groups: int = 32,
        add_downsample: bool = True,
        downsample_padding: int = 1,
        add_attention: bool = False,
        attn_num_head_channels: Optional[int] = 1,
    ):
        super().__init__()
        self.resnets = nn.ModuleList(
            _resnet(in_channels if i == 0 else out_channels, out_channels, None, resnet_eps, resnet_groups,
                    "default", 0.0)
            for i in range(num_layers)
        )
        self.attentions = nn.ModuleList(
            AttentionBlock(out_channels, num_head_channels=attn_num_head_channels, eps=resnet_eps,
                           norm_num_groups=resnet_groups)
            for _ in range(num_layers if add_attention else 0)
        )
        self.downsamplers = (
            nn.ModuleList([Downsample2D(out_channels, padding=downsample_padding)]) if add_downsample else None
        )

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        for i, resnet in enumerate(self.resnets):
            hidden = resnet(hidden)
            if len(self.attentions):
                hidden = self.attentions[i](hidden)
        if self.downsamplers is not None:
            hidden = self.downsamplers[0](hidden)
        return hidden


class UpDecoderBlock2D(nn.Module):
    """The VAE decoder's temb-free block: resnets (each optionally followed
    by attention), then an upsample."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        num_layers: int = 1,
        resnet_eps: float = 1e-6,
        resnet_groups: int = 32,
        add_upsample: bool = True,
        add_attention: bool = False,
        attn_num_head_channels: Optional[int] = 1,
    ):
        super().__init__()
        self.resnets = nn.ModuleList(
            _resnet(in_channels if i == 0 else out_channels, out_channels, None, resnet_eps, resnet_groups,
                    "default", 0.0)
            for i in range(num_layers)
        )
        self.attentions = nn.ModuleList(
            AttentionBlock(out_channels, num_head_channels=attn_num_head_channels, eps=resnet_eps,
                           norm_num_groups=resnet_groups)
            for _ in range(num_layers if add_attention else 0)
        )
        self.upsamplers = nn.ModuleList([Upsample2D(out_channels)]) if add_upsample else None

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        for i, resnet in enumerate(self.resnets):
            hidden = resnet(hidden)
            if len(self.attentions):
                hidden = self.attentions[i](hidden)
        if self.upsamplers is not None:
            hidden = self.upsamplers[0](hidden)
        return hidden
