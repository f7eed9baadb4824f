"""The reference's backdoor fine-tuning step, plain PyTorch in f32: poison,
BadDiffusion's l2 loss over the reference UNet, the gradients' global norm
clipped to a bound (scaled by bound/‖g‖ only when ‖g‖ ≥ bound, as optax's
``clip_by_global_norm``), then Adam (β 0.9/0.999, ε 1e-8 outside the square
root, bias-corrected) at a learning rate read at the update count before the
update, from a linear warm-up then a half cosine (diffusers'
``get_cosine_schedule_with_warmup``, which the reference trainer uses).

A step's batch runs as ``micro`` rows at a time (blocks of rows, so that an
f32 step at 256 px fits); their gradients are summed and divided by the
number of blocks, which is the gradient of the whole batch's mean.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from bench_port.reference import unet as ref_unet
from bench_port.reference.diffusion import Schedule, poison
from bench_port.reference.precision import Precision

B1, B2, EPS = 0.9, 0.999, 1e-8


def cosine_warmup_lr(base: float, warmup: int, total: int, count: int) -> float:
    if count < warmup:
        return base * count / max(1, warmup)
    progress = (count - warmup) / max(1, total - warmup)
    return base * max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))


class RefTrainer:
    """Owns f32 leaves of the parameters and Adam's moments."""

    def __init__(self, cfg: Dict, params: Dict[str, torch.Tensor], schedule: Schedule, lr: float, warmup: int,
                 total: int, clip: float, trigger, target, mask, prec: Optional[Precision] = None,
                 rows_kept: float = 1.0):
        self.cfg = cfg
        self.names = list(params)
        self.params = {n: p.detach().clone().float().requires_grad_(True) for n, p in params.items()}
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.schedule, self.lr, self.warmup, self.total, self.clip = schedule, lr, warmup, total, clip
        self.trigger, self.target, self.mask = trigger, target, mask
        self.prec = prec
        self.rows_kept = rows_kept  # < 1 only to read a fault: the loss over the first rows of each block
        self.count = 0

    def step(self, image_u8, is_clean, t, eps, micro: int) -> Dict:
        """One update. Returns the loss and the clipped gradients' per-leaf
        norms (what Adam receives)."""
        n = image_u8.shape[0]
        blocks = max(1, n // micro)
        for p in self.params.values():
            p.grad = None
        loss_sum = 0.0
        for i in range(blocks):
            rows = slice(i * micro, (i + 1) * micro)
            keep = max(1, int(round(micro * self.rows_kept)))
            sub = slice(rows.start, rows.start + keep)
            x0, r = poison(image_u8[sub], is_clean[sub], self.trigger, self.target, self.mask)
            x_t, goal = self.schedule.q_sample_backdoor(x0, r, t[sub], eps[sub])
            pred = ref_unet.forward(self.params, self.cfg, x_t, t[sub], self.prec)
            loss = torch.mean(torch.square(pred - goal)) / blocks
            loss.backward()
            loss_sum += float(loss.detach())
        grads = [self.params[name].grad for name in self.names]
        with torch.no_grad():
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            if float(norm) >= self.clip:
                for g in grads:
                    g.mul_(self.clip / norm)
            lr = cosine_warmup_lr(self.lr, self.warmup, self.total, self.count)
            self.count += 1
            c1, c2 = 1.0 - B1 ** self.count, 1.0 - B2 ** self.count
            leaf_norms = {}
            for name, g in zip(self.names, grads):
                leaf_norms[name] = float(torch.linalg.vector_norm(g))
                self.mu[name].mul_(B1).add_(g, alpha=1.0 - B1)
                self.nu[name].mul_(B2).addcmul_(g, g, value=1.0 - B2)
                update = (self.mu[name] / c1) / ((self.nu[name] / c2).sqrt() + EPS)
                self.params[name].sub_(lr * update)
        return {"loss": loss_sum, "grad_norms": leaf_norms}

    def change_norms(self, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """‖θ − θ₀‖ of each leaf."""
        with torch.no_grad():
            return {n: float(torch.linalg.vector_norm(self.params[n] - start[n].to(self.params[n].device)))
                    for n in self.names}


def names_moved(grad_norms: Dict[str, float], floor: float = 1e-3) -> List[str]:
    """The leaves whose reference gradient is at least ``floor`` times the
    median leaf's: a leaf below it (a key's bias under softmax) is moved by
    Adam from round-off alone, in any implementation."""
    ordered = sorted(grad_norms.values())
    median = ordered[len(ordered) // 2]
    return [n for n, v in grad_norms.items() if v >= floor * median]
