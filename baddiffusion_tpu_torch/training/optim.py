"""Optimizer and LR schedules (port of ``baddiffusion_tpu/training/optim.py``).

Adam (no weight decay) after a clip of the gradients' global norm to 1.0,
with an LR schedule; by default cosine with linear warmup:

  step < warmup:  lr · step/warmup
  else:           lr · max(0, 0.5·(1 + cos(π · num_cycles · 2 · progress)))

Semantics are optax's, which the JAX package uses, not PyTorch's defaults:
the clip scales by max/‖g‖ only when ‖g‖ ≥ max (``clip_grad_norm_`` always
scales, by max/(‖g‖+1e-6)); Adam's update is bias-corrected, with the
corrections 1 − β^t rounded to f32, and eps outside the square root; and
the LR is read at the step count *before* the update, so step 0 of a warmup
schedule has lr 0 and changes no parameter.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

Schedule = Callable[[int], float]
# torch.optim.Adam's defaults, which the reference trains with and the JAX
# package's optax.adam call fixes
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def cosine_schedule_with_warmup(
    base_lr: float, num_warmup_steps: int, num_training_steps: int, num_cycles: float = 0.5
) -> Schedule:
    def schedule(step: int) -> float:
        if step < num_warmup_steps:
            return base_lr * step / max(1.0, num_warmup_steps)
        progress = (step - num_warmup_steps) / max(1.0, num_training_steps - num_warmup_steps)
        return base_lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress)))

    return schedule


def linear_schedule_with_warmup(base_lr: float, num_warmup_steps: int, num_training_steps: int) -> Schedule:
    """Linear decay to 0 after the warmup."""

    def schedule(step: int) -> float:
        if step < num_warmup_steps:
            return base_lr * step / max(1.0, num_warmup_steps)
        return base_lr * max(0.0, (num_training_steps - step) / max(1.0, num_training_steps - num_warmup_steps))

    return schedule


def constant_schedule_with_warmup(base_lr: float, num_warmup_steps: int) -> Schedule:
    def schedule(step: int) -> float:
        return base_lr * (step / max(1.0, num_warmup_steps) if step < num_warmup_steps else 1.0)

    return schedule


def polynomial_schedule_with_warmup(
    base_lr: float, num_warmup_steps: int, num_training_steps: int, lr_end: float = 1e-7, power: float = 1.0
) -> Schedule:
    """Polynomial decay from lr to lr_end after the warmup."""

    def schedule(step: int) -> float:
        if step < num_warmup_steps:
            return base_lr * step / max(1.0, num_warmup_steps)
        if step > num_training_steps:
            return lr_end
        remaining = 1.0 - (step - num_warmup_steps) / max(1.0, num_training_steps - num_warmup_steps)
        return (base_lr - lr_end) * max(remaining, 0.0) ** power + lr_end

    return schedule


def cosine_with_restarts_schedule_with_warmup(
    base_lr: float, num_warmup_steps: int, num_training_steps: int, num_cycles: int = 1
) -> Schedule:
    """Cosine with hard restarts."""

    def schedule(step: int) -> float:
        if step < num_warmup_steps:
            return base_lr * step / max(1.0, num_warmup_steps)
        progress = (step - num_warmup_steps) / max(1.0, num_training_steps - num_warmup_steps)
        if progress >= 1.0:
            return 0.0
        return base_lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * ((num_cycles * progress) % 1.0))))

    return schedule


def _bias_correction(decay: float, count: int) -> float:
    """1 − decay^count in f32, as optax computes it: at b2 = 0.999 the f32
    value differs from the exact one by about 1e-5 relative, which every
    update carries."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


@dataclasses.dataclass
class AdamState:
    """Updates applied so far, and the first and second moments, one tensor
    per parameter in the parameters' order."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class Optimizer:
    """Clip by global norm (optax's form; skipped when ``grad_clip`` is
    None), then Adam with ``schedule``. ``update`` works in place on the
    gradients, the moments and the parameters, with foreach kernels."""

    def __init__(self, schedule: Schedule, grad_clip: Optional[float] = 1.0):
        self.schedule = schedule
        self.grad_clip = grad_clip

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        return AdamState(
            count=0,
            mu=[torch.zeros_like(p, memory_format=torch.preserve_format) for p in params],
            nu=[torch.zeros_like(p, memory_format=torch.preserve_format) for p in params],
        )

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: AdamState, params: List[torch.Tensor],
               norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step: clip ``grads``, advance ``state``, move ``params``.
        Returns the gradients' global norm before the clip (a 0-dim tensor on
        their device; nothing waits for the device). ``norm`` is that norm
        when the gradients are shards whose norm only the ranks together know
        (``parallel.ParallelLayout.grad_norm``)."""
        if norm is None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.grad_clip is not None:
            torch._foreach_mul_(grads, torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm))
        lr = self.schedule(state.count)
        state.count += 1
        torch._foreach_mul_(state.mu, ADAM_B1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - ADAM_B1)
        torch._foreach_mul_(state.nu, ADAM_B2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - ADAM_B2)
        denom = torch._foreach_div(state.nu, _bias_correction(ADAM_B2, state.count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        step = torch._foreach_div(state.mu, _bias_correction(ADAM_B1, state.count))
        torch._foreach_div_(step, denom)
        torch._foreach_add_(params, step, alpha=-lr)
        return norm


def make_optimizer(
    lr: float,
    num_warmup_steps: int = 500,
    num_training_steps: int = 100_000,
    grad_clip: Optional[float] = 1.0,
    schedule: str = "cosine",
):
    """(optimizer, lr_schedule): clip + Adam(ADAM_B1, ADAM_B2, ADAM_EPS) on
    ``schedule``."""
    if schedule == "cosine":
        lr_schedule = cosine_schedule_with_warmup(lr, num_warmup_steps, num_training_steps)
    elif schedule == "linear":
        lr_schedule = linear_schedule_with_warmup(lr, num_warmup_steps, num_training_steps)
    elif schedule == "constant_with_warmup":
        lr_schedule = constant_schedule_with_warmup(lr, num_warmup_steps)
    elif schedule == "polynomial":
        lr_schedule = polynomial_schedule_with_warmup(lr, num_warmup_steps, num_training_steps)
    elif schedule == "cosine_with_restarts":
        lr_schedule = cosine_with_restarts_schedule_with_warmup(lr, num_warmup_steps, num_training_steps)
    elif schedule == "constant":
        def lr_schedule(step: int) -> float:
            return lr
    else:
        raise NotImplementedError(f"schedule {schedule!r}")
    return Optimizer(lr_schedule, grad_clip=grad_clip), lr_schedule
