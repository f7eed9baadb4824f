"""DDIM, deterministic or η-stochastic (port of
``baddiffusion_tpu/schedulers/ddim.py``). ``step`` takes its noise as a
tensor, as the port's DDPM does; the chain draws it only when η > 0."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from baddiffusion_tpu_torch.schedulers.base import (
    ConfigurableScheduler,
    DiffusionSchedule,
    add_noise_common,
    get_velocity_common,
    pred_x0_from_model_output,
    register_scheduler,
    spaced_timesteps,
    threshold_sample,
)


@dataclasses.dataclass(frozen=True)
class DDIMConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "linear"
    trained_betas: Optional[tuple] = None
    clip_sample: bool = True
    set_alpha_to_one: bool = True
    steps_offset: int = 0
    prediction_type: str = "epsilon"
    thresholding: bool = False
    dynamic_thresholding_ratio: float = 0.995
    clip_sample_range: float = 1.0
    sample_max_value: float = 1.0
    # sampling-time knobs, kept in the config as the JAX package does
    eta: float = 0.0
    use_clipped_model_output: bool = False


@dataclasses.dataclass(frozen=True)
class DDIMState:
    schedule: DiffusionSchedule
    timesteps: np.ndarray  # [n] int32, descending
    num_inference_steps: int


@register_scheduler("DDIMScheduler")
class DDIMScheduler(ConfigurableScheduler):
    config_class = DDIMConfig
    init_noise_sigma = 1.0

    def create_state(self) -> DDIMState:
        T = self.config.num_train_timesteps
        return DDIMState(
            schedule=DiffusionSchedule.create(self.config),
            timesteps=np.arange(T)[::-1].copy().astype(np.int32),
            num_inference_steps=T,
        )

    def set_timesteps(self, state: DDIMState, num_inference_steps: int) -> DDIMState:
        ts = spaced_timesteps(self.config.num_train_timesteps, num_inference_steps) + self.config.steps_offset
        if ts.max() >= self.config.num_train_timesteps:
            raise ValueError(
                f"steps_offset={self.config.steps_offset} pushes timestep {int(ts.max())} "
                f"past num_train_timesteps={self.config.num_train_timesteps}; lower "
                "num_inference_steps or steps_offset"
            )
        return dataclasses.replace(state, timesteps=ts.astype(np.int32), num_inference_steps=num_inference_steps)

    def scale_model_input(self, state: DDIMState, sample: torch.Tensor, step_index=None) -> torch.Tensor:
        return sample

    def step_uses_noise(self, state: DDIMState, step_index: int) -> bool:
        return self.config.eta > 0

    def _alpha_prods(self, state: DDIMState, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ᾱ_t, ᾱ_prev) as 0-dim f32 tensors; past the first timestep ᾱ_prev
        is 1 (``set_alpha_to_one``) or ᾱ_0."""
        acp = state.schedule.alphas_cumprod
        prev_t = t - self.config.num_train_timesteps // state.num_inference_steps
        if prev_t >= 0:
            return acp[t], acp[prev_t]
        return acp[t], (torch.tensor(1.0) if self.config.set_alpha_to_one else acp[0])

    def variance(self, state: DDIMState, t: int) -> torch.Tensor:
        alpha_prod_t, alpha_prod_t_prev = self._alpha_prods(state, int(t))
        beta_prod_t = 1.0 - alpha_prod_t
        beta_prod_t_prev = 1.0 - alpha_prod_t_prev
        return (beta_prod_t_prev / beta_prod_t) * (1.0 - alpha_prod_t / alpha_prod_t_prev)

    def step(
        self,
        state: DDIMState,
        model_output: torch.Tensor,
        step_index: int,
        sample: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[DDIMState, torch.Tensor, torch.Tensor]:
        """DDIM update, formulas (12)/(16) of arXiv 2010.02502. ``noise`` ~
        N(0, 1) of the sample's shape is added (times σ_t) when η > 0."""
        cfg = self.config
        t = int(state.timesteps[step_index])
        alpha_prod_t, alpha_prod_t_prev = self._alpha_prods(state, t)
        beta_prod_t = 1.0 - alpha_prod_t

        pred_original_sample, pred_epsilon = pred_x0_from_model_output(
            cfg.prediction_type, sample, model_output, alpha_prod_t
        )
        if cfg.thresholding:
            pred_original_sample = threshold_sample(
                pred_original_sample, cfg.dynamic_thresholding_ratio, cfg.sample_max_value
            )
        elif cfg.clip_sample:
            pred_original_sample = torch.clamp(pred_original_sample, -cfg.clip_sample_range, cfg.clip_sample_range)

        std_dev_t = cfg.eta * self.variance(state, t) ** 0.5
        if cfg.use_clipped_model_output:
            pred_epsilon = (sample - alpha_prod_t**0.5 * pred_original_sample) / beta_prod_t**0.5

        pred_sample_direction = (1.0 - alpha_prod_t_prev - std_dev_t**2) ** 0.5 * pred_epsilon
        prev_sample = alpha_prod_t_prev**0.5 * pred_original_sample + pred_sample_direction
        if cfg.eta > 0 and noise is not None:
            prev_sample = prev_sample + std_dev_t * noise
        return state, prev_sample, pred_original_sample

    def add_noise(self, state: DDIMState, original, noise, timesteps) -> torch.Tensor:
        return add_noise_common(state.schedule.alphas_cumprod, original, noise, timesteps)

    def get_velocity(self, state: DDIMState, sample, noise, timesteps) -> torch.Tensor:
        return get_velocity_common(state.schedule.alphas_cumprod, sample, noise, timesteps)
