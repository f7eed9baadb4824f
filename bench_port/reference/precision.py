"""Lower-precision rounding for the comparison's control.

The control is the reference put in the program's place and computed one
precision below the one the cell states: bf16 for an f32 cell, fp8 for a
bf16 one. ``Precision(kind)`` rounds a product's operand to that precision
and back to f32, so the product runs on the rounded values with an f32 sum,
as tensor cores compute a product of that type. fp8 (``float8_e4m3fn``)
takes a scale a tensor, its largest magnitude mapped to the format's largest
value, as fp8 training does; bf16 needs none. Under autograd the gradient
that flows back through a rounded operand is rounded too (fp8 in
``float8_e5m2``, bf16 in bf16): the backward products run in the lower
precision as well.
"""

from __future__ import annotations

import torch

_FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to f32 (fp8 with a scale a tensor)."""
    if dtype in _FP8:
        amax = x.detach().abs().amax().float().clamp(min=1e-30)
        scale = _FP8[dtype] / amax
        return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)
    return x.to(dtype).to(x.dtype)


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return round_to(x, fwd)

    @staticmethod
    def backward(ctx, grad):
        return round_to(grad, ctx.bwd), None, None


class Precision:
    """A callable that rounds one operand; ``kind`` is ``"bf16"`` or ``"fp8"``."""

    KINDS = {"bf16": (torch.bfloat16, torch.bfloat16), "fp8": (torch.float8_e4m3fn, torch.float8_e5m2)}

    def __init__(self, kind: str):
        if kind not in self.KINDS:
            raise ValueError(f"precision {kind!r}: one of {sorted(self.KINDS)}")
        self.kind = kind
        self.fwd, self.bwd = self.KINDS[kind]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _Round.apply(x, self.fwd, self.bwd)


# the precision one step below each compute dtype a cell can state
BELOW = {"float32": "bf16", "bfloat16": "fp8"}
