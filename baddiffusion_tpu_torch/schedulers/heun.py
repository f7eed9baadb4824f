"""Heun discrete, Karras et al.'s Algorithm 2 (port of
``baddiffusion_tpu/schedulers/heun.py``): the interleaved timestep and σ
tables, the σ-scaled model input, and the alternation of a first-order
(Euler) step at even step indices with the second-order correction at odd
ones. The model sees float timesteps; ``init_noise_sigma`` is a function of
the state (the largest σ)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from baddiffusion_tpu_torch.schedulers.base import (
    ConfigurableScheduler,
    DiffusionSchedule,
    kdiffusion_sigma_table,
    register_scheduler,
)


@dataclasses.dataclass(frozen=True)
class HeunConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "linear"
    trained_betas: Optional[tuple] = None
    prediction_type: str = "epsilon"


@dataclasses.dataclass(frozen=True)
class HeunState:
    schedule: DiffusionSchedule
    timesteps: np.ndarray  # [2n-1] float32
    sigmas: torch.Tensor  # [2n] f32
    num_inference_steps: int
    prev_derivative: Optional[torch.Tensor] = None
    dt: Optional[torch.Tensor] = None
    stored_sample: Optional[torch.Tensor] = None


def sigma_pred_x0(prediction_type: str, sample, model_output, sigma):
    """x₀ from a σ-parametrised model output (Heun, K-LMS)."""
    if prediction_type == "epsilon":
        return sample - sigma * model_output
    if prediction_type == "v_prediction":
        return model_output * (-sigma / (sigma**2 + 1.0) ** 0.5) + sample / (sigma**2 + 1.0)
    if prediction_type == "sample":
        return model_output
    raise ValueError(prediction_type)


@register_scheduler("HeunDiscreteScheduler")
class HeunDiscreteScheduler(ConfigurableScheduler):
    config_class = HeunConfig
    order = 2

    @staticmethod
    def init_noise_sigma(state: HeunState) -> torch.Tensor:
        return state.sigmas.max()

    def create_state(self) -> HeunState:
        schedule = DiffusionSchedule.create(self.config)
        acp = schedule.alphas_cumprod.numpy()
        sigmas = ((1 - acp) / acp) ** 0.5
        T = self.config.num_train_timesteps
        return HeunState(
            schedule=schedule,
            timesteps=np.linspace(0, T - 1, T, dtype=np.float32)[::-1].copy(),
            sigmas=torch.from_numpy(np.concatenate([sigmas[::-1], [0.0]]).astype(np.float32)),
            num_inference_steps=T,
        )

    def set_timesteps(self, state: HeunState, num_inference_steps: int) -> HeunState:
        acp = state.schedule.alphas_cumprod.numpy()
        ts, sigmas = kdiffusion_sigma_table(acp, num_inference_steps, self.config.num_train_timesteps)
        sigmas = np.concatenate([sigmas[:1], np.repeat(sigmas[1:-1], 2), sigmas[-1:]])
        ts = np.concatenate([ts[:1], np.repeat(ts[1:], 2)]).astype(np.float32)
        return dataclasses.replace(state, timesteps=ts, sigmas=torch.from_numpy(sigmas),
                                   num_inference_steps=num_inference_steps)

    def begin_sampling(self, state: HeunState, sample: torch.Tensor) -> HeunState:
        return dataclasses.replace(state, prev_derivative=None, dt=None, stored_sample=None)

    def scale_model_input(self, state: HeunState, sample: torch.Tensor, step_index: int) -> torch.Tensor:
        sigma = state.sigmas[step_index]
        return sample / ((sigma**2 + 1.0) ** 0.5)

    def step(
        self,
        state: HeunState,
        model_output: torch.Tensor,
        step_index: int,
        sample: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[HeunState, torch.Tensor, torch.Tensor]:
        if self.config.prediction_type not in ("epsilon", "v_prediction"):
            raise ValueError(self.config.prediction_type)
        i = step_index
        if i % 2 == 0:  # first order: an Euler step from σ_i to σ_{i+1}, kept for the correction
            sigma_hat, sigma_next = state.sigmas[i], state.sigmas[i + 1]
            pred_x0 = sigma_pred_x0(self.config.prediction_type, sample, model_output, sigma_hat)
            derivative = (sample - pred_x0) / sigma_hat
            dt = sigma_next - sigma_hat
            state = dataclasses.replace(state, prev_derivative=derivative, dt=dt, stored_sample=sample)
            return state, sample + derivative * dt, pred_x0
        # second order: the mean of the two slopes, from the stored sample
        sigma_next = state.sigmas[i]
        pred_x0 = sigma_pred_x0(self.config.prediction_type, sample, model_output, sigma_next)
        derivative = ((sample - pred_x0) / sigma_next + state.prev_derivative) / 2.0
        return state, state.stored_sample + derivative * state.dt, pred_x0

    def add_noise(self, state: HeunState, original, noise, timesteps):
        """σ-space noising: each timestep matched against the interleaved
        table, first occurrence."""
        ts = torch.from_numpy(state.timesteps)
        idx = torch.searchsorted(-ts, -timesteps.cpu().to(ts.dtype))
        sigma = state.sigmas[idx].to(original.device).reshape((-1,) + (1,) * (original.dim() - 1))
        return original + noise * sigma
