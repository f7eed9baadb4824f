"""Karras-VE stochastic sampler, EDM Algorithm 2 in its VE column (port of
``baddiffusion_tpu/schedulers/karras_ve.py``): the geometric schedule, the
churn that adds noise to the input, the Euler step and its second-order
correction, and the engine ``sample_karras_ve`` that drives them. The model
sees ``(x + 1) / 2`` at timestep ``σ / 2`` and its output is scaled by σ/2.

The engine skips what a step does not use: the churn's noise draw where γ is
0 (σ outside [s_min, s_max]) and the correction's model call on the last
step, where σ_prev is 0 and the Euler step is the result. A chain of n
steps so makes 2n − 1 UNet forwards (the JAX engine computes 2n and
discards the last)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from baddiffusion_tpu_torch.schedulers.base import ConfigurableScheduler, register_scheduler


@dataclasses.dataclass(frozen=True)
class KarrasVeConfig:
    sigma_min: float = 0.02
    sigma_max: float = 100.0
    s_noise: float = 1.007
    s_churn: float = 80.0
    s_min: float = 0.05
    s_max: float = 50.0
    num_train_timesteps: int = 1000


@dataclasses.dataclass(frozen=True)
class KarrasVeState:
    timesteps: np.ndarray  # [n] int32, descending
    schedule: torch.Tensor  # [n] f32, σ(t_i)
    num_inference_steps: int


@register_scheduler("KarrasVeScheduler")
class KarrasVeScheduler(ConfigurableScheduler):
    config_class = KarrasVeConfig
    order = 2

    @property
    def init_noise_sigma(self):
        return self.config.sigma_max

    def create_state(self) -> KarrasVeState:
        return self.set_timesteps(None, self.config.num_train_timesteps)

    def set_timesteps(self, state, num_inference_steps: int) -> KarrasVeState:
        cfg = self.config
        ts = np.arange(0, num_inference_steps)[::-1].copy()
        schedule = [
            cfg.sigma_max**2 * (cfg.sigma_min**2 / cfg.sigma_max**2) ** (i / (num_inference_steps - 1))
            for i in ts
        ]
        return KarrasVeState(
            timesteps=ts.astype(np.int32),
            schedule=torch.from_numpy(np.asarray(schedule, np.float32)),
            num_inference_steps=num_inference_steps,
        )

    def scale_model_input(self, state, sample, step_index=None):
        return sample

    def churn(self, state: KarrasVeState, sigma: torch.Tensor) -> torch.Tensor:
        """γ: the churn of a step at σ, 0 outside [s_min, s_max]."""
        cfg = self.config
        f32 = torch.float32
        if bool((torch.tensor(cfg.s_min, dtype=f32) <= sigma) & (sigma <= torch.tensor(cfg.s_max, dtype=f32))):
            return torch.tensor(min(cfg.s_churn / state.num_inference_steps, 2**0.5 - 1), dtype=f32)
        return torch.tensor(0.0)

    def add_noise_to_input(self, state: KarrasVeState, sample, sigma, noise: Optional[torch.Tensor]):
        """(sample_hat, σ_hat); ``noise`` may be None where γ is 0."""
        gamma = self.churn(state, sigma)
        sigma_hat = sigma + gamma * sigma
        if noise is None:
            return sample, sigma_hat
        eps = self.config.s_noise * noise
        # max(·, 0) before the root, as the JAX package does
        return sample + torch.sqrt(torch.clamp(sigma_hat**2 - sigma**2, min=0.0)) * eps, sigma_hat

    def step(self, state, model_output, sigma_hat, sigma_prev, sample_hat):
        pred_x0 = sample_hat + sigma_hat * model_output
        derivative = (sample_hat - pred_x0) / sigma_hat
        sample_prev = sample_hat + (sigma_prev - sigma_hat) * derivative
        return sample_prev, derivative, pred_x0

    def step_correct(self, state, model_output, sigma_hat, sigma_prev, sample_hat, sample_prev, derivative):
        pred_x0 = sample_prev + sigma_prev * model_output
        derivative_corr = (sample_prev - pred_x0) / sigma_prev
        sample_prev = sample_hat + (sigma_prev - sigma_hat) * (0.5 * derivative + 0.5 * derivative_corr)
        return sample_prev, derivative_corr, pred_x0


def sample_karras_ve(
    scheduler: KarrasVeScheduler,
    state: KarrasVeState,
    model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    init: torch.Tensor,
    draw_noise: Callable[[int], torch.Tensor],
    capture_every: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The Karras-VE chain. ``draw_noise(i)`` gives step i's churn noise
    (called only where the churn is non-zero). Returns (sample, movie) in
    model space ([-1, 1]: the pipeline maps them to images); the movie is
    ``[frames, *init.shape]``, its last frame the result, or None."""
    sample = init * torch.tensor(scheduler.init_noise_sigma, dtype=init.dtype)
    n = len(state.timesteps)
    b = init.shape[0]

    def model(x, sigma):
        t = torch.full((b,), float(sigma / 2.0), dtype=torch.float32, device=x.device)
        return (sigma / 2.0) * model_fn((x + 1.0) / 2.0, t).to(x.dtype)

    frames = None
    if capture_every:
        frames = torch.zeros((-(-n // capture_every),) + tuple(init.shape), dtype=init.dtype, device=init.device)
    for i in range(n):
        t = int(state.timesteps[i])
        sigma = state.schedule[t]
        sigma_prev = state.schedule[t - 1] if t > 0 else torch.tensor(0.0)
        noise = draw_noise(i) if bool(scheduler.churn(state, sigma) > 0) else None
        sample_hat, sigma_hat = scheduler.add_noise_to_input(state, sample, sigma, noise)
        sample, derivative, _ = scheduler.step(state, model(sample_hat, sigma_hat), sigma_hat, sigma_prev, sample_hat)
        if t > 0:
            sample, _, _ = scheduler.step_correct(state, model(sample, sigma_prev), sigma_hat, sigma_prev,
                                                  sample_hat, sample, derivative)
        if capture_every and (i % capture_every == 0 or i == n - 1):
            frames[i // capture_every] = sample
    return sample, frames
