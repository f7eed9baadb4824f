"""ResNet block and resampling layers (port of the non-FIR part of
``baddiffusion_tpu/models/resnet.py``).

Layout: every module takes and returns NHWC tensors, as the JAX package does.
An NHWC tensor that is contiguous is an NCHW tensor in ``torch.channels_last``
memory, so ``Conv2d`` hands cuDNN a channels_last NCHW view and views its
channels_last result back as NHWC, without a copy. Concatenation, nearest
upsampling and padding therefore all work on the channel-last axis and can
never hand the GroupNorm kernel a tensor in NCHW-contiguous memory.

Compute dtype as flax does it: parameters keep their own dtype (f32), and
``Conv2d``/``Linear`` cast weight and bias to the dtype of the activation they
are given, so a bf16 activation makes a bf16 product and autograd hands back
f32 gradients through the cast. A weight already in that dtype is not copied.
GroupNorm statistics are single-pass f32, clamped, with the affine applied in
f32 from f32 γ/β (ops/groupnorm.py). Every GroupNorm that a SiLU follows goes
through the fused kernels on the card (K1 forward, K2 backward).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from baddiffusion_tpu_torch.ops import groupnorm_plain, groupnorm_silu


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` on NHWC activations (weights stay OIHW), computed in the
    activation's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self._conv_forward(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), self.bias.to(x.dtype))
        return out.permute(0, 2, 3, 1)


class Linear(nn.Linear):
    """``nn.Linear`` computed in the activation's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class GroupNorm(nn.Module):
    """GroupNorm over the channel (last) axis with f32 single-pass statistics
    and an f32 affine, output in x's dtype; ``silu=True`` fuses the SiLU that
    follows (the GroupNorm+SiLU kernels). γ/β reach the kernels in f32: a
    module cast to another dtype pays one cast of each per call."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5, silu: bool = False):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"channels {num_channels} not divisible by num_groups {num_groups}")
        self.num_groups = num_groups
        self.eps = eps
        self.silu = silu
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.weight.float(), self.bias.float()
        if self.silu:
            return groupnorm_silu(x, weight, bias, self.num_groups, self.eps)
        return groupnorm_plain(x, weight, bias, self.num_groups, self.eps)


class Upsample2D(nn.Module):
    """Nearest 2x upsample, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        return self.conv(x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c))


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv downsample.

    ``padding=0`` reproduces the google/ddpm checkpoints' asymmetric pad (one
    row at the bottom, one column at the right) before an unpadded conv.
    """

    def __init__(self, channels: int, padding: int = 1):
        super().__init__()
        self.padding = padding
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == 0:
            x = F.pad(x, (0, 0, 0, 1, 0, 1))  # NHWC: C untouched, W and H +1 at the end
        return self.conv(x)


class ResnetBlock2D(nn.Module):
    """norm1 → SiLU → conv1 → (+ time proj) → norm2 → [scale_shift] → SiLU →
    dropout → conv2 → (+ shortcut) / output_scale_factor."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        temb_channels: int,
        groups: int = 32,
        eps: float = 1e-6,
        time_embedding_norm: str = "default",
        output_scale_factor: float = 1.0,
        dropout: float = 0.0,
    ):
        super().__init__()
        if time_embedding_norm not in ("default", "scale_shift"):
            raise ValueError(f"time_embedding_norm {time_embedding_norm!r}")
        self.scale_shift = time_embedding_norm == "scale_shift"
        self.output_scale_factor = output_scale_factor
        self.norm1 = GroupNorm(groups, in_channels, eps, silu=True)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = Linear(temb_channels, 2 * out_channels if self.scale_shift else out_channels)
        # scale_shift modulates between the norm and the SiLU, so norm2 is
        # plain there; the default form fuses the SiLU into the kernel
        self.norm2 = GroupNorm(groups, out_channels, eps, silu=not self.scale_shift)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        hidden = self.conv1(self.norm1(x))
        temb = self.time_emb_proj(F.silu(temb))[:, None, None, :]
        if self.scale_shift:
            scale, shift = temb.chunk(2, dim=-1)
            hidden = F.silu(self.norm2(hidden) * (1 + scale) + shift)
        else:
            hidden = self.norm2(hidden + temb)
        hidden = self.conv2(self.dropout(hidden))

        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        out = x + hidden
        # x / 1.0 is x: skip the launch
        return out if self.output_scale_factor == 1.0 else out / self.output_scale_factor
