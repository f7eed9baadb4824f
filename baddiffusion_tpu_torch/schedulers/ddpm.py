"""DDPM ancestral sampler (port of ``baddiffusion_tpu/schedulers/ddpm.py``),
including BadDiffusion's ``clip_defense`` knob.

The JAX step draws its noise from a key inside itself; here ``step`` takes
the noise tensor (or None), and its caller draws it from a
``torch.Generator`` — or, in the tests, hands in the JAX package's own draws.
Layout is NHWC: the learned-variance split is on the last axis.
"""

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
class DDPMConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "linear"
    trained_betas: Optional[tuple] = None
    variance_type: str = "fixed_small"
    clip_sample: bool = True
    prediction_type: str = "epsilon"
    thresholding: bool = False
    dynamic_thresholding_ratio: float = 0.995
    clip_sample_range: float = 1.0
    sample_max_value: float = 1.0
    # BadDiffusion's defense knob: clamp x_{t-1} AFTER noise addition.
    clip_defense: bool = False
    clip_defense_range: float = 1.0


@dataclasses.dataclass(frozen=True)
class DDPMState:
    schedule: DiffusionSchedule
    timesteps: np.ndarray  # [n] int32, descending
    num_inference_steps: int


_ONE = torch.tensor(1.0)


@register_scheduler("DDPMScheduler")
class DDPMScheduler(ConfigurableScheduler):
    config_class = DDPMConfig
    init_noise_sigma = 1.0

    def create_state(self) -> DDPMState:
        T = self.config.num_train_timesteps
        return DDPMState(
            schedule=DiffusionSchedule.create(self.config),
            timesteps=np.arange(T)[::-1].copy().astype(np.int32),
            num_inference_steps=T,
        )

    def set_timesteps(self, state: DDPMState, num_inference_steps: int) -> DDPMState:
        ts = spaced_timesteps(self.config.num_train_timesteps, num_inference_steps)
        return dataclasses.replace(state, timesteps=ts, num_inference_steps=num_inference_steps)

    def scale_model_input(self, state: DDPMState, sample: torch.Tensor, step_index=None) -> torch.Tensor:
        return sample

    def step_uses_noise(self, state: DDPMState, step_index: int) -> bool:
        return int(state.timesteps[step_index]) > 0  # at t = 0 the noise term is zero

    def _alpha_prods(self, state: DDPMState, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ᾱ_t, ᾱ_prev) as 0-dim f32 tensors; ᾱ_prev = 1 before the first step."""
        acp = state.schedule.alphas_cumprod
        prev_t = t - self.config.num_train_timesteps // state.num_inference_steps
        return acp[t], (acp[prev_t] if prev_t >= 0 else _ONE)

    def variance(
        self,
        state: DDPMState,
        t: int,
        predicted_variance: Optional[torch.Tensor] = None,
        variance_type: Optional[str] = None,
    ) -> torch.Tensor:
        """Posterior variance β̃_t with the variance_type variants."""
        alpha_prod_t, alpha_prod_t_prev = self._alpha_prods(state, int(t))
        current_beta_t = 1.0 - alpha_prod_t / alpha_prod_t_prev
        variance = torch.clamp((1.0 - alpha_prod_t_prev) / (1.0 - alpha_prod_t) * current_beta_t, min=1e-20)

        vt = variance_type or self.config.variance_type
        if vt == "fixed_small":
            return variance
        if vt == "fixed_small_log":
            return torch.exp(0.5 * torch.log(variance))
        if vt == "fixed_large":
            return current_beta_t
        if vt == "fixed_large_log":
            return torch.log(current_beta_t)
        if vt == "learned":
            return predicted_variance
        if vt == "learned_range":
            min_log = torch.log(variance)
            max_log = torch.log(current_beta_t)
            frac = (predicted_variance + 1.0) / 2.0
            return frac * max_log + (1.0 - frac) * min_log
        raise NotImplementedError(f"variance_type {vt!r}")

    def step(
        self,
        state: DDPMState,
        model_output: torch.Tensor,
        step_index: int,
        sample: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[DDPMState, torch.Tensor, torch.Tensor]:
        """One reverse step x_t → x_{t-1}; ``noise`` ~ N(0, 1) of the sample's
        shape, or None for the mean. Returns (state, prev_sample, pred_x0)."""
        cfg = self.config
        t = int(state.timesteps[step_index])

        predicted_variance = None
        if cfg.variance_type in ("learned", "learned_range") and model_output.shape[-1] == sample.shape[-1] * 2:
            model_output, predicted_variance = model_output.chunk(2, dim=-1)

        alpha_prod_t, alpha_prod_t_prev = self._alpha_prods(state, t)
        beta_prod_t = 1.0 - alpha_prod_t
        beta_prod_t_prev = 1.0 - alpha_prod_t_prev
        current_alpha_t = alpha_prod_t / alpha_prod_t_prev
        current_beta_t = 1.0 - current_alpha_t

        pred_original_sample, _ = pred_x0_from_model_output(cfg.prediction_type, sample, model_output, alpha_prod_t)

        if cfg.thresholding:
            pred_original_sample = threshold_sample(
                pred_original_sample, cfg.dynamic_thresholding_ratio, cfg.sample_max_value
            )
        elif cfg.clip_sample:
            pred_original_sample = torch.clamp(pred_original_sample, -cfg.clip_sample_range, cfg.clip_sample_range)

        # posterior mean coefficients, formula (7) of arXiv 2006.11239
        pred_original_sample_coeff = (alpha_prod_t_prev**0.5) * current_beta_t / beta_prod_t
        current_sample_coeff = (current_alpha_t**0.5) * beta_prod_t_prev / beta_prod_t
        pred_prev_sample = pred_original_sample_coeff * pred_original_sample + current_sample_coeff * sample

        if noise is not None and t > 0:  # at t = 0 the noise term is zero
            if cfg.variance_type == "fixed_small_log":
                sigma = self.variance(state, t, predicted_variance)
            elif cfg.variance_type == "learned_range":
                sigma = torch.exp(0.5 * self.variance(state, t, predicted_variance))
            else:
                sigma = self.variance(state, t, predicted_variance) ** 0.5
            pred_prev_sample = pred_prev_sample + sigma * noise

        if cfg.clip_defense:
            pred_prev_sample = torch.clamp(pred_prev_sample, -cfg.clip_defense_range, cfg.clip_defense_range)
        return state, pred_prev_sample, pred_original_sample

    def add_noise(self, state: DDPMState, original: torch.Tensor, noise: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        return add_noise_common(state.schedule.alphas_cumprod, original, noise, timesteps)

    def get_velocity(self, state: DDPMState, sample: torch.Tensor, noise: torch.Tensor,
                     timesteps: torch.Tensor) -> torch.Tensor:
        return get_velocity_common(state.schedule.alphas_cumprod, sample, noise, timesteps)
