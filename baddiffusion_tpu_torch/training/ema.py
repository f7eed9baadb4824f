"""EMA of model parameters (port of ``baddiffusion_tpu/training/ema.py``).

The reference's ``EMAModel`` (diffusers ``training_utils.py``) as an update
of a dict of tensors in place, with foreach ops and an explicit step count:

  s     = max(0, step − update_after_step − 1)
  decay = 0                                  while s ≤ 0
        = 1 − (1 + s/inv_gamma)^−power       with use_warmup
        = (1 + s)/(10 + s)                   otherwise
  then clamped to [min_decay, max_decay]

The decay is computed in f32, as the JAX package computes it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class EMAState:
    """The shadow parameters, by name, and the reference's optimization step."""

    params: Dict[str, torch.Tensor]
    step: int


def ema_init(params: Dict[str, torch.Tensor]) -> EMAState:
    return EMAState(params={k: p.detach().clone() for k, p in params.items()}, step=0)


def ema_decay(
    step: int,
    max_decay: float = 0.9999,
    use_warmup: bool = False,
    inv_gamma: float = 1.0,
    power: float = 2.0 / 3.0,
    update_after_step: int = 0,
    min_decay: float = 0.0,
) -> np.float32:
    """The decay at optimization step ``step``, in f32."""
    f32 = np.float32
    s = f32(max(0, step - update_after_step - 1))
    if s <= 0:
        return f32(0.0)
    if use_warmup:
        value = f32(1.0) - (f32(1.0) + s / f32(inv_gamma)) ** f32(-power)
    else:
        value = (f32(1.0) + s) / (f32(10.0) + s)
    return f32(np.clip(value, f32(min_decay), f32(max_decay)))


@torch.no_grad()
def ema_update(state: EMAState, new_params: Dict[str, torch.Tensor], max_decay: float = 0.9999, **kwargs) -> EMAState:
    """One reference ``EMAModel.step``: advance the step, then, in place,
    shadow ← d·shadow + (1 − d)·params. Returns ``state``."""
    state.step += 1
    d = ema_decay(state.step, max_decay=max_decay, **kwargs)
    shadow = list(state.params.values())
    params = [new_params[k].detach().to(s.dtype) for k, s in state.params.items()]
    torch._foreach_mul_(shadow, float(d))
    torch._foreach_add_(shadow, torch._foreach_mul(params, float(np.float32(1.0) - d)))
    return state
