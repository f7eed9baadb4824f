"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit): the only rates a share is taken against.

f32 work is held to the TF32 tensor rate. On this card no f32 product gives
a correct f32 result faster than one TF32 product does (the f32 pipes outside
the tensor cores peak at 67 TFLOP/s, and a TF32-split product takes three
TF32 products), so no implementation of an f32 cell can read over 100% of
it; against the 67 TFLOP/s rate a TF32 convolution would. No exponential or
special-function rate is used as a bound: none is published.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOPS = {"bfloat16": 989e12, "float32": 495e12}  # float32 at the TF32 rate, as above
