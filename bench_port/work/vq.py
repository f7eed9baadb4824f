"""The VQ-VAE's work from its configuration's shapes, as ``work/model.py``
counts the UNet's: the yardstick's operation and byte counts, independent of
the kernels that do the work.

``vq_sites(cfg)`` walks the published encoder and decoder (the layout
``reference/vq.py`` follows) and gives, for one image: the products of an
encode (encoder and ``quant_conv``) and of a decode (``post_quant_conv`` and
decoder), each conv 2·k²·C_in·C_out·H_out·W_out operations, the mid block's
attention its four dense layers (2·C² a token each) and its two products
(4·T²·C); each one's GroupNorm+SiLU sites (the resnets' two norms and
``conv_norm_out``: K1) and attention sites (one head as wide as the block:
K3).

``quantize_least_seconds`` is the least time of one quantizer call over
``n`` vectors: 2·D·K operations a vector (a product and a sum for each
element of each code's ‖e‖² − 2 z·e; the compares are not counted, as K3's
count leaves out its exponentials) at the f32 rate ``work/peaks.py`` holds
f32 work to, or its bytes (z and the codebook read once, the int64 indices
and the f32 codebook rows written once) at 3.35 TB/s, whichever is larger.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from bench_port.work.peaks import FLOPS, HBM_BYTES_PER_S

F32 = 4


@dataclasses.dataclass(frozen=True)
class VQSites:
    encode_flops: float  # one image
    decode_flops: float  # one image
    encode_gn_silu: List[tuple]  # (H, W, C, groups), in call order
    decode_gn_silu: List[tuple]
    encode_attention: List[tuple]  # (heads, T, d)
    decode_attention: List[tuple]
    latent_size: int
    embed_dim: int
    codes: int


def vq_sites(cfg: Dict) -> VQSites:
    chans = list(cfg["block_out_channels"])
    layers = cfg["layers_per_block"]
    groups = cfg.get("norm_num_groups", 32)
    latent = cfg["latent_channels"]
    dim = cfg.get("vq_embed_dim") or latent
    flops = [0.0]
    gn: List[tuple] = []
    attn: List[tuple] = []

    def conv(cin, cout, k, res_out):
        flops[0] += 2.0 * k * k * cin * cout * res_out * res_out

    def resnet(cin, cout, res):
        gn.append((res, res, cin, groups))
        conv(cin, cout, 3, res)
        gn.append((res, res, cout, groups))
        conv(cout, cout, 3, res)
        if cin != cout:
            conv(cin, cout, 1, res)

    def mid(c, res):
        t = res * res
        resnet(c, c, res)
        flops[0] += 4 * 2.0 * c * c * t + 4.0 * t * t * c
        attn.append((1, t, c))
        resnet(c, c, res)

    res = cfg["sample_size"]
    conv(cfg["in_channels"], chans[0], 3, res)
    out = chans[0]
    for i in range(len(cfg["down_block_types"])):
        cin, out = out, chans[i]
        for j in range(layers):
            resnet(cin if j == 0 else out, out, res)
        if i != len(chans) - 1:
            res //= 2
            conv(out, out, 3, res)
    mid(chans[-1], res)
    gn.append((res, res, chans[-1], groups))
    conv(chans[-1], latent, 3, res)
    conv(latent, dim, 1, res)
    latent_size = res
    encode = (flops[0], gn[:], attn[:])

    flops[0], gn[:], attn[:] = 0.0, [], []
    rev = list(reversed(chans))
    conv(dim, latent, 1, res)
    conv(latent, rev[0], 3, res)
    mid(rev[0], res)
    out = rev[0]
    for i in range(len(cfg["up_block_types"])):
        cin, out = out, rev[i]
        for j in range(layers + 1):
            resnet(cin if j == 0 else out, out, res)
        if i != len(chans) - 1:
            res *= 2
            conv(out, out, 3, res)
    gn.append((res, res, chans[0], groups))
    conv(chans[0], cfg["out_channels"], 3, res)
    return VQSites(encode[0], flops[0], encode[1], gn, encode[2], attn, latent_size, dim, cfg["num_vq_embeddings"])


def quantize_least_seconds(s: VQSites, n: int) -> float:
    """The least time of one quantizer call over ``n`` latent vectors."""
    ops = 2.0 * s.embed_dim * s.codes * n
    moved = F32 * s.embed_dim * (2 * n + s.codes) + 8.0 * n
    return max(ops / FLOPS["float32"], moved / HBM_BYTES_PER_S)
