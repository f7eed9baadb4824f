"""Model work from a configuration's shapes: the yardstick's operation and
byte counts, independent of the kernels that do the work.

``sites(cfg, size)`` walks the published UNet (the same block layout the
reference follows) and lists, for one image:

- every product: convs (2·k²·C_in·C_out·H_out·W_out operations), dense
  layers (2·in·out a token) and the two attention products (2·T²·d each a
  head, so 4·T²·d);
- every GroupNorm that a SiLU follows (``gn_silu``: the resnets' two norms
  and ``conv_norm_out``), which the program runs as K1 forward and K2
  backward;
- every attention (``attention``: heads, T, d), which it runs as K3.

Model FLOPs of a forward are the sum of the products. A training step counts
three forwards (the backward's two products a forward product), and no
recomputation; elementwise work is not counted, as ``FlopCounterMode`` does
not count it either.

Bytes of a call count each input read once and each output written once, in
the activations' dtype: K1 reads x and writes y (training also writes the
f32 mean and rstd, ``[B, G]``); K2 reads x and ∂y and writes ∂x, and reads
the statistics and writes ∂γ, ∂β in f32; K3 reads q, k, v and writes the
output. γ and β are read once a call in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

F32 = 4
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


@dataclasses.dataclass(frozen=True)
class Sites:
    product_flops: float  # a forward of one image
    gn_silu: List[tuple]  # (H, W, C, groups) of each GroupNorm+SiLU, in call order
    attention: List[tuple]  # (heads, T, d) of each attention, in call order


def sites(cfg: Dict, size: int) -> Sites:
    chans = list(cfg["block_out_channels"])
    layers = cfg["layers_per_block"]
    groups = cfg.get("norm_num_groups", 32)
    head_dim = cfg.get("attention_head_dim")
    c0, temb = chans[0], chans[0] * 4
    flops = 0.0
    gn: List[tuple] = []
    attn: List[tuple] = []

    def conv(cin, cout, k, hw_out):
        nonlocal flops
        flops += 2.0 * k * k * cin * cout * hw_out

    def dense(cin, cout, tokens=1):
        nonlocal flops
        flops += 2.0 * cin * cout * tokens

    def resnet(cin, cout, res):
        gn.append((res, res, cin, groups))
        conv(cin, cout, 3, res * res)
        dense(temb, cout)
        gn.append((res, res, cout, groups))
        conv(cout, cout, 3, res * res)
        if cin != cout:
            conv(cin, cout, 1, res * res)

    def attention(c, res):
        nonlocal flops
        heads = 1 if head_dim is None else c // head_dim
        t, d = res * res, c // heads
        for _ in range(4):  # query, key, value, proj_attn
            dense(c, c, t)
        flops += 4.0 * heads * t * t * d
        attn.append((heads, t, d))

    dense(c0, temb)
    dense(temb, temb)
    conv(cfg["in_channels"], c0, 3, size * size)
    res, out = size, c0
    for i, kind in enumerate(cfg["down_block_types"]):
        cin, out = out, chans[i]
        for j in range(layers):
            resnet(cin if j == 0 else out, out, res)
            if kind == "AttnDownBlock2D":
                attention(out, res)
        if i != len(chans) - 1:
            res //= 2
            conv(out, out, 3, res * res)
    mid = chans[-1]
    resnet(mid, mid, res)
    attention(mid, res)
    resnet(mid, mid, res)
    rev = list(reversed(chans))
    out = rev[0]
    for i, kind in enumerate(cfg["up_block_types"]):
        prev, out = out, rev[i]
        skip_in = rev[min(i + 1, len(chans) - 1)]
        for j in range(layers + 1):
            res_skip = skip_in if j == layers else out
            resnet((prev if j == 0 else out) + res_skip, out, res)
            if kind == "AttnUpBlock2D":
                attention(out, res)
        if i != len(chans) - 1:
            res *= 2
            conv(out, out, 3, res * res)
    gn.append((res, res, c0, groups))
    conv(c0, cfg["out_channels"], 3, res * res)
    return Sites(flops, gn, attn)


def k1_bytes(s: Sites, batch: int, dtype: str, save_stats: bool) -> float:
    """Bytes of every K1 call of one forward over ``batch`` rows."""
    e = DTYPE_BYTES[dtype]
    total = 0.0
    for h, w, c, g in s.gn_silu:
        total += 2.0 * batch * h * w * c * e + 2.0 * c * F32
        if save_stats:
            total += 2.0 * batch * g * F32
    return total


def k2_bytes(s: Sites, batch: int, dtype: str) -> float:
    """Bytes of every K2 call of one backward over ``batch`` rows."""
    e = DTYPE_BYTES[dtype]
    return sum(3.0 * batch * h * w * c * e + 2.0 * batch * g * F32 + 4.0 * c * F32 for h, w, c, g in s.gn_silu)


def k3_least_seconds(s: Sites, batch: int, dtype: str, flop_rate: float, byte_rate: float) -> float:
    """The least time of every K3 call of one forward over ``batch`` rows:
    each call's larger of its products at ``flop_rate`` and its bytes (q, k,
    v read, the output written) at ``byte_rate``."""
    e = DTYPE_BYTES[dtype]
    total = 0.0
    for heads, t, d in s.attention:
        flops = 4.0 * batch * heads * t * t * d
        moved = 4.0 * batch * heads * t * d * e
        total += max(flops / flop_rate, moved / byte_rate)
    return total
