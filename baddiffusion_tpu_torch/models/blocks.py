"""UNet2D building blocks, NHWC (port of the non-skip blocks of
``baddiffusion_tpu/models/blocks.py``): DownBlock2D, AttnDownBlock2D,
UpBlock2D, AttnUpBlock2D and UNetMidBlock2D. The FIR skip blocks (NCSN++) and
the VAE encoder/decoder blocks are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from baddiffusion_tpu_torch.models.attention import AttentionBlock
from baddiffusion_tpu_torch.models.resnet import Downsample2D, ResnetBlock2D, Upsample2D


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
    """resnet → (attention → resnet) × num_layers."""

    def __init__(
        self,
        in_channels: int,
        temb_channels: int,
        num_layers: int = 1,
        resnet_eps: float = 1e-6,
        resnet_time_scale_shift: str = "default",
        resnet_groups: int = 32,
        add_attention: bool = True,
        attn_num_head_channels: Optional[int] = 1,
        output_scale_factor: float = 1.0,
        dropout: float = 0.0,
    ):
        super().__init__()
        self.resnets = nn.ModuleList(
            _resnet(in_channels, in_channels, temb_channels, resnet_eps, resnet_groups,
                    resnet_time_scale_shift, dropout, output_scale_factor)
            for _ in range(num_layers + 1)
        )
        self.attentions = nn.ModuleList(
            AttentionBlock(in_channels, num_head_channels=attn_num_head_channels,
                           rescale_output_factor=output_scale_factor, eps=resnet_eps, norm_num_groups=resnet_groups)
            for _ in range(num_layers if add_attention else 0)
        )

    def forward(self, hidden: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        hidden = self.resnets[0](hidden, temb)
        for i, resnet in enumerate(self.resnets[1:]):
            if len(self.attentions):
                hidden = self.attentions[i](hidden)
            hidden = resnet(hidden, temb)
        return hidden
