"""Plain f32 PyTorch UNet of the published DDPM family (google/ddpm-cifar10-32,
google/ddpm-ema-celebahq-256): the benchmark's reference for the UNet.

Written from the published ``unet/config.json`` keys and the diffusers-0.16
``UNet2DModel`` it names, with nothing of the measured package: NCHW
tensors, ``F.conv2d``/``F.linear``/``F.group_norm``, attention as two
batched products around a softmax. Parameters are a ``{name: tensor}`` dict
with the published state-dict names, so the one set of weights the benchmark
draws loads into the program and feeds this function alike.

Blocks covered: ``DownBlock2D``, ``AttnDownBlock2D``, ``UpBlock2D``,
``AttnUpBlock2D``, the mid block with one attention, the positional time
embedding, ``resnet_time_scale_shift="default"``, ``downsample_padding`` 0
(one row and column of zeros at the bottom and right before an unpadded
stride-2 conv) or 1. Any other key value raises.

``prec`` rounds the operands of every product (conv, dense, the two
attention products) to a lower precision first (``reference/precision.py``):
the lower-precision control of the comparison. None computes in f32, which
is the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from bench_port.reference.precision import Precision

Spec = List[Tuple[str, Tuple[int, ...], str]]

_DOWN = ("DownBlock2D", "AttnDownBlock2D")
_UP = ("UpBlock2D", "AttnUpBlock2D")


def _check(cfg: Dict) -> None:
    unsupported = {
        "time_embedding_type": ("positional",),
        "resnet_time_scale_shift": ("default",),
        "act_fn": ("silu",),
        "center_input_sample": (False,),
        "add_attention": (True,),
        "class_embed_type": (None,),
        "num_class_embeds": (None,),
    }
    for key, allowed in unsupported.items():
        if cfg.get(key, allowed[0]) not in allowed:
            raise NotImplementedError(f"reference UNet: {key}={cfg[key]!r}")
    for t in cfg["down_block_types"]:
        if t not in _DOWN:
            raise NotImplementedError(f"reference UNet: down block {t}")
    for t in cfg["up_block_types"]:
        if t not in _UP:
            raise NotImplementedError(f"reference UNet: up block {t}")


def _heads(cfg: Dict, channels: int) -> int:
    head_dim = cfg.get("attention_head_dim")
    return 1 if head_dim is None else channels // head_dim


def param_spec(cfg: Dict) -> Spec:
    """(name, shape, kind) of every parameter, in the published order. kind is
    ``weight`` (conv and dense kernels), ``bias``, ``norm_weight`` or
    ``norm_bias``."""
    _check(cfg)
    spec: Spec = []

    def conv(name, cin, cout, k):
        spec.extend([(f"{name}.weight", (cout, cin, k, k), "weight"), (f"{name}.bias", (cout,), "bias")])

    def dense(name, cin, cout):
        spec.extend([(f"{name}.weight", (cout, cin), "weight"), (f"{name}.bias", (cout,), "bias")])

    def norm(name, c):
        spec.extend([(f"{name}.weight", (c,), "norm_weight"), (f"{name}.bias", (c,), "norm_bias")])

    def resnet(name, cin, cout, temb):
        norm(f"{name}.norm1", cin)
        conv(f"{name}.conv1", cin, cout, 3)
        dense(f"{name}.time_emb_proj", temb, cout)
        norm(f"{name}.norm2", cout)
        conv(f"{name}.conv2", cout, cout, 3)
        if cin != cout:
            conv(f"{name}.conv_shortcut", cin, cout, 1)

    def attention(name, c):
        norm(f"{name}.group_norm", c)
        for part in ("query", "key", "value", "proj_attn"):
            dense(f"{name}.{part}", c, c)

    chans = list(cfg["block_out_channels"])
    c0, temb = chans[0], chans[0] * 4
    layers = cfg["layers_per_block"]
    dense("time_embedding.linear_1", c0, temb)
    dense("time_embedding.linear_2", temb, temb)
    conv("conv_in", cfg["in_channels"], c0, 3)
    out = c0
    for i, kind in enumerate(cfg["down_block_types"]):
        cin, out = out, chans[i]
        for j in range(layers):
            resnet(f"down_blocks.{i}.resnets.{j}", cin if j == 0 else out, out, temb)
        if kind == "AttnDownBlock2D":
            for j in range(layers):
                attention(f"down_blocks.{i}.attentions.{j}", out)
        if i != len(chans) - 1:
            conv(f"down_blocks.{i}.downsamplers.0.conv", out, out, 3)
    mid = chans[-1]
    resnet("mid_block.resnets.0", mid, mid, temb)
    resnet("mid_block.resnets.1", mid, mid, temb)
    attention("mid_block.attentions.0", mid)
    rev = list(reversed(chans))
    out = rev[0]
    for i, kind in enumerate(cfg["up_block_types"]):
        prev, out = out, rev[i]
        skip_in = rev[min(i + 1, len(chans) - 1)]
        for j in range(layers + 1):
            res_skip = skip_in if j == layers else out
            resnet(f"up_blocks.{i}.resnets.{j}", (prev if j == 0 else out) + res_skip, out, temb)
        if kind == "AttnUpBlock2D":
            for j in range(layers + 1):
                attention(f"up_blocks.{i}.attentions.{j}", out)
        if i != len(chans) - 1:
            conv(f"up_blocks.{i}.upsamplers.0.conv", out, out, 3)
    norm("conv_norm_out", c0)
    conv("conv_out", c0, cfg["out_channels"], 3)
    return spec


def init_params(cfg: Dict, generator: torch.Generator, device: torch.device) -> Dict[str, torch.Tensor]:
    """Seeded weights on ``device`` in f32, drawn in one call: kernels
    N(0, 1/fan_in), biases 0.02·N(0, 1), norm scales 1 + 0.05·N(0, 1), norm
    shifts 0.05·N(0, 1). Each parameter is a contiguous view of one buffer."""
    spec = param_spec(cfg)
    total = sum(math.prod(shape) for _, shape, _ in spec)
    flat = torch.randn(total, generator=generator, device=device, dtype=torch.float32)
    params, offset = {}, 0
    with torch.no_grad():
        for name, shape, kind in spec:
            n = math.prod(shape)
            view = flat[offset:offset + n].view(shape)
            offset += n
            if kind == "weight":
                view.mul_(math.prod(shape[1:]) ** -0.5)
            elif kind == "bias":
                view.mul_(0.02)
            elif kind == "norm_weight":
                view.mul_(0.05).add_(1.0)
            else:
                view.mul_(0.05)
            params[name] = view
    return params


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool, shift: float) -> torch.Tensor:
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / (half - shift)
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


class _Net:
    """One forward's closure over the parameters and the precision."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: Dict, prec: Optional[Precision]):
        self.p, self.cfg, self.prec = params, cfg, prec
        self.eps = cfg.get("norm_eps", 1e-5)
        self.groups = cfg.get("norm_num_groups", 32)

    def q(self, x):
        return x if self.prec is None else self.prec(x)

    def conv(self, name, x, stride=1, padding=1):
        w = self.p[f"{name}.weight"]
        return F.conv2d(self.q(x), self.q(w), self.p[f"{name}.bias"], stride=stride, padding=padding)

    def dense(self, name, x):
        return F.linear(self.q(x), self.q(self.p[f"{name}.weight"]), self.p[f"{name}.bias"])

    def norm(self, name, x):
        return F.group_norm(x, self.groups, self.p[f"{name}.weight"], self.p[f"{name}.bias"], self.eps)

    def resnet(self, name, x, temb, scale=1.0):
        h = self.conv(f"{name}.conv1", F.silu(self.norm(f"{name}.norm1", x)))
        h = h + self.dense(f"{name}.time_emb_proj", F.silu(temb))[:, :, None, None]
        h = self.conv(f"{name}.conv2", F.silu(self.norm(f"{name}.norm2", h)))
        if f"{name}.conv_shortcut.weight" in self.p:
            x = self.conv(f"{name}.conv_shortcut", x, padding=0)
        return (x + h) / scale

    def attention(self, name, x, scale=1.0):
        b, c, hh, ww = x.shape
        heads = _heads(self.cfg, c)
        d = c // heads
        tokens = self.norm(f"{name}.group_norm", x).reshape(b, c, hh * ww).transpose(1, 2)

        def split(t):  # [b, T, c] -> [b·heads, T, d]
            return t.reshape(b, hh * ww, heads, d).transpose(1, 2).reshape(b * heads, hh * ww, d)

        q = split(self.dense(f"{name}.query", tokens))
        k = split(self.dense(f"{name}.key", tokens))
        v = split(self.dense(f"{name}.value", tokens))
        probs = torch.softmax(torch.bmm(self.q(q), self.q(k).transpose(1, 2)) / math.sqrt(d), dim=-1)
        out = torch.bmm(self.q(probs), self.q(v))
        out = out.reshape(b, heads, hh * ww, d).transpose(1, 2).reshape(b, hh * ww, c)
        out = self.dense(f"{name}.proj_attn", out).transpose(1, 2).reshape(b, c, hh, ww)
        return (out + x) / scale

    def forward(self, sample_nhwc: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        chans = list(cfg["block_out_channels"])
        layers = cfg["layers_per_block"]
        x = sample_nhwc.float().permute(0, 3, 1, 2)
        t = timesteps.expand(x.shape[0]) if timesteps.dim() == 0 else timesteps
        temb = timestep_embedding(t, chans[0], cfg.get("flip_sin_to_cos", True), cfg.get("freq_shift", 0))
        temb = self.dense("time_embedding.linear_2", F.silu(self.dense("time_embedding.linear_1", temb)))
        h = self.conv("conv_in", x)
        skips = [h]
        for i, kind in enumerate(cfg["down_block_types"]):
            for j in range(layers):
                h = self.resnet(f"down_blocks.{i}.resnets.{j}", h, temb)
                if kind == "AttnDownBlock2D":
                    h = self.attention(f"down_blocks.{i}.attentions.{j}", h)
                skips.append(h)
            if i != len(chans) - 1:
                pad = cfg.get("downsample_padding", 1)
                if pad == 0:
                    h = F.pad(h, (0, 1, 0, 1))
                h = self.conv(f"down_blocks.{i}.downsamplers.0.conv", h, stride=2, padding=pad)
                skips.append(h)
        scale = cfg.get("mid_block_scale_factor", 1.0)
        h = self.resnet("mid_block.resnets.0", h, temb, scale)
        h = self.attention("mid_block.attentions.0", h, scale)
        h = self.resnet("mid_block.resnets.1", h, temb, scale)
        for i, kind in enumerate(cfg["up_block_types"]):
            for j in range(layers + 1):
                h = self.resnet(f"up_blocks.{i}.resnets.{j}", torch.cat([h, skips.pop()], dim=1), temb)
                if kind == "AttnUpBlock2D":
                    h = self.attention(f"up_blocks.{i}.attentions.{j}", h)
            if i != len(chans) - 1:
                h = self.conv(f"up_blocks.{i}.upsamplers.0.conv", F.interpolate(h, scale_factor=2.0, mode="nearest"))
        h = self.conv("conv_out", F.silu(self.norm("conv_norm_out", h)))
        return h.permute(0, 2, 3, 1)


def forward(params: Dict[str, torch.Tensor], cfg: Dict, sample_nhwc: torch.Tensor, timesteps: torch.Tensor,
            prec: Optional[Precision] = None) -> torch.Tensor:
    """ε-prediction ``[B, H, W, C]`` in f32 for ``sample_nhwc`` ``[B, H, W, C]``
    at integer ``timesteps`` ``[B]``."""
    _check(cfg)
    return _Net(params, cfg, prec).forward(sample_nhwc, timesteps)
