"""Legacy-DDPM spatial self-attention block, NHWC (port of
``baddiffusion_tpu/models/attention.py``).

GroupNorm (plain: no SiLU follows) → q/k/v linear over the H·W tokens →
attention (ops/attention.py: the hand-written kernel on the card) → proj →
residual add / rescale. The legacy ``group_norm/query/key/value/proj_attn``
names give the HF state-dict keys.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from baddiffusion_tpu_torch.models.resnet import GroupNorm, Linear
from baddiffusion_tpu_torch.ops import attention


class AttentionBlock(nn.Module):
    def __init__(
        self,
        channels: int,
        num_head_channels: Optional[int] = None,
        norm_num_groups: int = 32,
        rescale_output_factor: float = 1.0,
        eps: float = 1e-5,
    ):
        super().__init__()
        self.num_heads = channels // num_head_channels if num_head_channels is not None else 1
        self.rescale_output_factor = rescale_output_factor
        self.group_norm = GroupNorm(norm_num_groups, channels, eps)
        self.query = Linear(channels, channels)
        self.key = Linear(channels, channels)
        self.value = Linear(channels, channels)
        self.proj_attn = Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        heads = self.num_heads
        head_dim = c // heads
        hidden = self.group_norm(x).reshape(b, h * w, c)

        def split_heads(t):  # [b, t, c] -> contiguous [b, heads, t, head_dim]
            return t.reshape(b, h * w, heads, head_dim).transpose(1, 2).contiguous()

        q = split_heads(self.query(hidden))
        k = split_heads(self.key(hidden))
        v = split_heads(self.value(hidden))
        attn = attention(q, k, v, 1.0 / (float(head_dim) ** 0.5))
        attn = attn.transpose(1, 2).reshape(b, h * w, c)
        out = self.proj_attn(attn).reshape(b, h, w, c) + x
        return out if self.rescale_output_factor == 1.0 else out / self.rescale_output_factor
