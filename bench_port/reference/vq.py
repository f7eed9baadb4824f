"""Plain f32 PyTorch VQ-VAE of latent diffusion (CompVis/ldm-celebahq-256's
``vqvae``): the benchmark's reference for the VQ model.

Written from the published ``vqvae/config.json`` keys and the diffusers-0.16
``VQModel`` it names, with nothing of the measured package: NCHW tensors,
``F.conv2d``/``F.linear``/``F.group_norm``, attention as two batched products
around a softmax. Parameters are a ``{name: tensor}`` dict with the published
state-dict names, so the one set of weights the benchmark draws loads into
the program and feeds these functions alike.

- ``Encoder``: ``conv_in``, ``DownEncoderBlock2D`` blocks (resnets without a
  time embedding; a stride-2 conv after one row and column of zeros at the
  bottom and right, on every block but the last), the temb-free
  ``UNetMidBlock2D`` (resnet, one attention head as wide as the block,
  resnet), GroupNorm + SiLU, ``conv_out``; then ``quant_conv``.
- ``Decoder``: ``post_quant_conv``, ``conv_in``, the mid block,
  ``UpDecoderBlock2D`` blocks of ``layers_per_block + 1`` resnets (a nearest
  2x upsample and a 3x3 conv on every block but the last), GroupNorm + SiLU,
  ``conv_out``.
- The quantizer: the nearest codebook row of each latent vector by the
  expanded L2 ‖z‖² + ‖e‖² − 2 z·e, computed over blocks of rows, the lowest
  index among ties (``torch.argmin``); the decoder takes the codebook rows
  through the straight-through form z + (z_q − z).

GroupNorm eps 1e-6 everywhere, as diffusers' ``Encoder``/``Decoder`` set
it. Departures from the published model: the quantizer's training loss and
its ``legacy``/``remap`` options are left out (sampling never reads them),
and an image goes in and out NHWC (``[B, H, W, C]``, the program's layout),
converted at the ends.

``prec`` rounds the operands of every product (conv, dense, the two
attention products and the quantizer's z·e) to a lower precision first
(``reference/precision.py``): the lower-precision control of the
comparison. None computes in f32, which is the reference. The caller sets
``torch.backends.cuda.matmul.allow_tf32`` and ``torch.backends.cudnn.allow_tf32``
to False (``common.full_f32``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from bench_port.reference.precision import Precision

EPS = 1e-6
Spec = List[Tuple[str, Tuple[int, ...], str]]


def _check(cfg: Dict) -> None:
    for t in cfg["down_block_types"]:
        if t != "DownEncoderBlock2D":
            raise NotImplementedError(f"reference VQ-VAE: down block {t}")
    for t in cfg["up_block_types"]:
        if t != "UpDecoderBlock2D":
            raise NotImplementedError(f"reference VQ-VAE: up block {t}")
    if cfg.get("act_fn", "silu") != "silu":
        raise NotImplementedError(f"reference VQ-VAE: act_fn={cfg['act_fn']!r}")


def embed_dim(cfg: Dict) -> int:
    return cfg.get("vq_embed_dim") or cfg["latent_channels"]


def param_spec(cfg: Dict) -> Spec:
    """(name, shape, kind) of every parameter. kind is ``weight`` (conv and
    dense kernels), ``bias``, ``norm_weight``, ``norm_bias`` or ``codebook``."""
    _check(cfg)
    spec: Spec = []

    def conv(name, cin, cout, k):
        spec.extend([(f"{name}.weight", (cout, cin, k, k), "weight"), (f"{name}.bias", (cout,), "bias")])

    def norm(name, c):
        spec.extend([(f"{name}.weight", (c,), "norm_weight"), (f"{name}.bias", (c,), "norm_bias")])

    def resnet(name, cin, cout):
        norm(f"{name}.norm1", cin)
        conv(f"{name}.conv1", cin, cout, 3)
        norm(f"{name}.norm2", cout)
        conv(f"{name}.conv2", cout, cout, 3)
        if cin != cout:
            conv(f"{name}.conv_shortcut", cin, cout, 1)

    def mid(name, c):
        resnet(f"{name}.resnets.0", c, c)
        resnet(f"{name}.resnets.1", c, c)
        norm(f"{name}.attentions.0.group_norm", c)
        for part in ("query", "key", "value", "proj_attn"):
            spec.extend([(f"{name}.attentions.0.{part}.weight", (c, c), "weight"),
                         (f"{name}.attentions.0.{part}.bias", (c,), "bias")])

    chans = list(cfg["block_out_channels"])
    layers = cfg["layers_per_block"]
    latent, dim = cfg["latent_channels"], embed_dim(cfg)
    conv("encoder.conv_in", cfg["in_channels"], chans[0], 3)
    out = chans[0]
    for i in range(len(cfg["down_block_types"])):
        cin, out = out, chans[i]
        for j in range(layers):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", cin if j == 0 else out, out)
        if i != len(chans) - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", out, out, 3)
    mid("encoder.mid_block", chans[-1])
    norm("encoder.conv_norm_out", chans[-1])
    conv("encoder.conv_out", chans[-1], latent, 3)
    conv("quant_conv", latent, dim, 1)
    spec.append(("quantize.embedding.weight", (cfg["num_vq_embeddings"], dim), "codebook"))
    conv("post_quant_conv", dim, latent, 1)
    rev = list(reversed(chans))
    conv("decoder.conv_in", latent, rev[0], 3)
    mid("decoder.mid_block", rev[0])
    out = rev[0]
    for i in range(len(cfg["up_block_types"])):
        cin, out = out, rev[i]
        for j in range(layers + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", cin if j == 0 else out, out)
        if i != len(chans) - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", out, out, 3)
    norm("decoder.conv_norm_out", chans[0])
    conv("decoder.conv_out", chans[0], cfg["out_channels"], 3)
    return spec


def init_params(cfg: Dict, generator: torch.Generator, device: torch.device) -> Dict[str, torch.Tensor]:
    """Seeded weights on ``device`` in f32, drawn in one call: kernels
    N(0, 1/fan_in), biases 0.02·N(0, 1), norm scales 1 + 0.05·N(0, 1), norm
    shifts 0.05·N(0, 1), the codebook N(0, 1). Each parameter is a
    contiguous view of one buffer."""
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
            elif kind == "norm_bias":
                view.mul_(0.05)
            params[name] = view
    return params


class _Net:
    """One call's closure over the parameters and the precision."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: Dict, prec: Optional[Precision]):
        self.p, self.cfg, self.prec = params, cfg, prec
        self.groups = cfg.get("norm_num_groups", 32)

    def q(self, x):
        return x if self.prec is None else self.prec(x)

    def conv(self, name, x, stride=1, padding=1):
        return F.conv2d(self.q(x), self.q(self.p[f"{name}.weight"]), self.p[f"{name}.bias"], stride=stride,
                        padding=padding)

    def dense(self, name, x):
        return F.linear(self.q(x), self.q(self.p[f"{name}.weight"]), self.p[f"{name}.bias"])

    def norm(self, name, x):
        return F.group_norm(x, self.groups, self.p[f"{name}.weight"], self.p[f"{name}.bias"], EPS)

    def resnet(self, name, x):
        h = self.conv(f"{name}.conv1", F.silu(self.norm(f"{name}.norm1", x)))
        h = self.conv(f"{name}.conv2", F.silu(self.norm(f"{name}.norm2", h)))
        if f"{name}.conv_shortcut.weight" in self.p:
            x = self.conv(f"{name}.conv_shortcut", x, padding=0)
        return x + h

    def attention(self, name, x):
        b, c, hh, ww = x.shape
        tokens = self.norm(f"{name}.group_norm", x).reshape(b, c, hh * ww).transpose(1, 2)
        q, k, v = (self.dense(f"{name}.{part}", tokens) for part in ("query", "key", "value"))
        probs = torch.softmax(torch.bmm(self.q(q), self.q(k).transpose(1, 2)) / math.sqrt(c), dim=-1)
        out = self.dense(f"{name}.proj_attn", torch.bmm(self.q(probs), self.q(v)))
        return out.transpose(1, 2).reshape(b, c, hh, ww) + x

    def mid(self, name, x):
        x = self.resnet(f"{name}.resnets.0", x)
        x = self.attention(f"{name}.attentions.0", x)
        return self.resnet(f"{name}.resnets.1", x)

    def encode(self, x):
        cfg = self.cfg
        chans, layers = list(cfg["block_out_channels"]), cfg["layers_per_block"]
        h = self.conv("encoder.conv_in", x)
        for i in range(len(cfg["down_block_types"])):
            for j in range(layers):
                h = self.resnet(f"encoder.down_blocks.{i}.resnets.{j}", h)
            if i != len(chans) - 1:
                h = self.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", F.pad(h, (0, 1, 0, 1)), stride=2,
                              padding=0)
        h = self.mid("encoder.mid_block", h)
        h = self.conv("encoder.conv_out", F.silu(self.norm("encoder.conv_norm_out", h)))
        return self.conv("quant_conv", h, padding=0)

    def decode(self, z_q):
        cfg = self.cfg
        chans, layers = list(cfg["block_out_channels"]), cfg["layers_per_block"]
        h = self.conv("decoder.conv_in", self.conv("post_quant_conv", z_q, padding=0))
        h = self.mid("decoder.mid_block", h)
        for i in range(len(cfg["up_block_types"])):
            for j in range(layers + 1):
                h = self.resnet(f"decoder.up_blocks.{i}.resnets.{j}", h)
            if i != len(chans) - 1:
                h = self.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv",
                              F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return self.conv("decoder.conv_out", F.silu(self.norm("decoder.conv_norm_out", h)))


def encode(params: Dict[str, torch.Tensor], cfg: Dict, image_nhwc: torch.Tensor,
           prec: Optional[Precision] = None) -> torch.Tensor:
    """Latents ``[B, H/f, W/f, D]`` (``quant_conv``'s output, not quantized)
    in f32 of images ``[B, H, W, C]``."""
    _check(cfg)
    return _Net(params, cfg, prec).encode(image_nhwc.float().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def decode(params: Dict[str, torch.Tensor], cfg: Dict, z_q_nhwc: torch.Tensor,
           prec: Optional[Precision] = None) -> torch.Tensor:
    """Images ``[B, H, W, C]`` in f32 of quantized latents ``[B, h, w, D]``."""
    _check(cfg)
    return _Net(params, cfg, prec).decode(z_q_nhwc.float().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def distances(codebook: torch.Tensor, flat: torch.Tensor, prec: Optional[Precision] = None) -> torch.Tensor:
    """The expanded L2 ‖z‖² + ‖e‖² − 2 z·e of each vector of ``flat``
    ``[n, D]`` to each code ``[K, D]``, in f32: ``[n, K]``."""
    z, e = (flat, codebook) if prec is None else (prec(flat), prec(codebook))
    return z.square().sum(dim=1, keepdim=True) + e.square().sum(dim=1)[None, :] - 2.0 * (z @ e.T)


def quantize(params: Dict[str, torch.Tensor], latents_nhwc: torch.Tensor, rows: int = 1 << 15,
             prec: Optional[Precision] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices ``[B, h, w]``, the quantized latents z + (z_q − z)) of
    latents ``[B, h, w, D]``, the distances taken ``rows`` vectors at a
    time."""
    codebook = params["quantize.embedding.weight"]
    z = latents_nhwc.float()
    flat = z.reshape(-1, codebook.shape[1])
    idx = torch.cat([torch.argmin(distances(codebook, flat[r:r + rows], prec), dim=1)
                     for r in range(0, flat.shape[0], rows)])
    z_q = codebook[idx].reshape(z.shape)
    return idx.reshape(z.shape[:-1]), z + (z_q - z)
