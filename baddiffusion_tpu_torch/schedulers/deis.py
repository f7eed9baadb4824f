"""DEIS, log-ρ multistep (port of ``baddiffusion_tpu/schedulers/deis.py``):
the model output converted to x₀ (thresholded when configured) and back to ε,
a first-order update equal to DDIM's, the second- and third-order log-ρ
polynomial coefficients, and DPM-Solver's warm-up and ordering rules."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from baddiffusion_tpu_torch.schedulers.base import (
    ConfigurableScheduler,
    DiffusionSchedule,
    add_noise_common,
    convert_multistep_model_output,
    multistep_solver_step,
    multistep_state_init,
    multistep_timesteps,
    register_scheduler,
)


@dataclasses.dataclass(frozen=True)
class DEISConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "linear"
    trained_betas: Optional[tuple] = None
    solver_order: int = 2
    prediction_type: str = "epsilon"
    thresholding: bool = False
    dynamic_thresholding_ratio: float = 0.995
    sample_max_value: float = 1.0
    algorithm_type: str = "deis"
    solver_type: str = "logrho"
    lower_order_final: bool = True


@dataclasses.dataclass(frozen=True)
class DEISState:
    schedule: DiffusionSchedule
    alpha_t: torch.Tensor
    sigma_t: torch.Tensor
    lambda_t: torch.Tensor
    timesteps: np.ndarray
    num_inference_steps: int
    model_outputs: Optional[Tuple[torch.Tensor, ...]] = None
    lower_order_nums: int = 0


@register_scheduler("DEISMultistepScheduler")
class DEISMultistepScheduler(ConfigurableScheduler):
    config_class = DEISConfig
    init_noise_sigma = 1.0

    def _normalize_config(self, config):
        if config.algorithm_type != "deis":
            if config.algorithm_type not in ("dpmsolver", "dpmsolver++"):
                raise NotImplementedError(
                    f"algorithm_type {config.algorithm_type!r} is not implemented for DEISMultistepScheduler"
                )
            config = dataclasses.replace(config, algorithm_type="deis")
        if config.solver_type != "logrho":
            if config.solver_type not in ("midpoint", "heun", "bh1", "bh2"):
                raise NotImplementedError(
                    f"solver_type {config.solver_type!r} is not implemented for DEISMultistepScheduler"
                )
            config = dataclasses.replace(config, solver_type="logrho")
        return config

    def create_state(self) -> DEISState:
        return multistep_state_init(DEISState, self.config)

    def set_timesteps(self, state: DEISState, num_inference_steps: int) -> DEISState:
        ts = multistep_timesteps(self.config.num_train_timesteps, num_inference_steps)
        return dataclasses.replace(state, timesteps=ts, num_inference_steps=len(ts))

    def begin_sampling(self, state: DEISState, sample: torch.Tensor) -> DEISState:
        return dataclasses.replace(state, model_outputs=(), lower_order_nums=0)

    def scale_model_input(self, state, sample, step_index=None):
        return sample

    def convert_model_output(self, state: DEISState, model_output, t: int, sample):
        return convert_multistep_model_output(
            self.config, "x0_to_epsilon", sample, model_output, state.schedule.alphas_cumprod[t]
        )

    def _first_order(self, state, m0, t, prev_t, sample):
        lam_t, lam_s = state.lambda_t[prev_t], state.lambda_t[t]
        a_t, a_s = state.alpha_t[prev_t], state.alpha_t[t]
        s_t = state.sigma_t[prev_t]
        h = lam_t - lam_s
        return (a_t / a_s) * sample - (s_t * (torch.exp(h) - 1.0)) * m0

    def _second_order(self, state, m0, m1, t_s0, t_s1, prev_t, sample):
        a_t, a_s0, a_s1 = state.alpha_t[prev_t], state.alpha_t[t_s0], state.alpha_t[t_s1]
        s_t, s_s0, s_s1 = state.sigma_t[prev_t], state.sigma_t[t_s0], state.sigma_t[t_s1]
        rho_t, rho_s0, rho_s1 = s_t / a_t, s_s0 / a_s0, s_s1 / a_s1

        def ind_fn(t, b, c):
            return t * (-torch.log(c) + torch.log(t) - 1.0) / (torch.log(b) - torch.log(c))

        coef1 = ind_fn(rho_t, rho_s0, rho_s1) - ind_fn(rho_s0, rho_s0, rho_s1)
        coef2 = ind_fn(rho_t, rho_s1, rho_s0) - ind_fn(rho_s0, rho_s1, rho_s0)
        return a_t * (sample / a_s0 + coef1 * m0 + coef2 * m1)

    def _third_order(self, state, m0, m1, m2, t_s0, t_s1, t_s2, prev_t, sample):
        a_t = state.alpha_t[prev_t]
        a_s0, a_s1, a_s2 = state.alpha_t[t_s0], state.alpha_t[t_s1], state.alpha_t[t_s2]
        s_t = state.sigma_t[prev_t]
        s_s0, s_s1, s_s2 = state.sigma_t[t_s0], state.sigma_t[t_s1], state.sigma_t[t_s2]
        rho_t, rho_s0, rho_s1, rho_s2 = s_t / a_t, s_s0 / a_s0, s_s1 / a_s1, s_s2 / a_s2

        def ind_fn(t, b, c, d):
            numerator = t * (
                torch.log(c) * (torch.log(d) - torch.log(t) + 1.0)
                - torch.log(d) * torch.log(t)
                + torch.log(d)
                + torch.log(t) ** 2
                - 2.0 * torch.log(t)
                + 2.0
            )
            denominator = (torch.log(b) - torch.log(c)) * (torch.log(b) - torch.log(d))
            return numerator / denominator

        coef1 = ind_fn(rho_t, rho_s0, rho_s1, rho_s2) - ind_fn(rho_s0, rho_s0, rho_s1, rho_s2)
        coef2 = ind_fn(rho_t, rho_s1, rho_s2, rho_s0) - ind_fn(rho_s0, rho_s1, rho_s2, rho_s0)
        coef3 = ind_fn(rho_t, rho_s2, rho_s0, rho_s1) - ind_fn(rho_s0, rho_s2, rho_s0, rho_s1)
        return a_t * (sample / a_s0 + coef1 * m0 + coef2 * m1 + coef3 * m2)

    def step(
        self,
        state: DEISState,
        model_output: torch.Tensor,
        step_index: int,
        sample: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[DEISState, torch.Tensor, torch.Tensor]:
        return multistep_solver_step(self, state, model_output, step_index, sample)

    def add_noise(self, state: DEISState, original, noise, timesteps):
        return add_noise_common(state.schedule.alphas_cumprod, original, noise, timesteps)
