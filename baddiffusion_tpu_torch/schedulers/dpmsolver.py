"""DPM-Solver and DPM-Solver++ multistep, orders 1–3 (port of
``baddiffusion_tpu/schedulers/dpmsolver.py``): linspace timestep spacing
(or Karras σ), ε ↔ x₀ conversion per algorithm, the first/second/third-order
updates, and the warm-up and ``lower_order_final`` rules of
``multistep_solver_step``. Every coefficient is a 0-dim f32 host tensor."""

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
class DPMSolverConfig:
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
    algorithm_type: str = "dpmsolver++"
    solver_type: str = "midpoint"
    lower_order_final: bool = True
    use_karras_sigmas: bool = False


@dataclasses.dataclass(frozen=True)
class DPMSolverState:
    schedule: DiffusionSchedule
    alpha_t: torch.Tensor  # [T] f32 = √ᾱ
    sigma_t: torch.Tensor  # [T] f32 = √(1−ᾱ)
    lambda_t: torch.Tensor  # [T] f32 = log α − log σ
    timesteps: np.ndarray  # [n] int32, descending
    num_inference_steps: int
    model_outputs: Optional[Tuple[torch.Tensor, ...]] = None  # newest last
    lower_order_nums: int = 0


def karras_timesteps(alphas_cumprod: np.ndarray, num_inference_steps: int) -> np.ndarray:
    """Karras-ρ resampling of the σ table, mapped back to timesteps."""
    sigmas = ((1 - alphas_cumprod) / alphas_cumprod) ** 0.5
    log_sigmas = np.log(sigmas)
    sigma_min, sigma_max = sigmas[-1], sigmas[0]
    rho = 7.0
    ramp = np.linspace(0, 1, num_inference_steps)
    k_sigmas = (sigma_max ** (1 / rho) + ramp * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho

    def sigma_to_t(sigma):
        log_sigma = np.log(sigma)
        dists = log_sigma - log_sigmas
        low_idx = np.clip(np.cumsum(dists >= 0).argmax(), 0, len(log_sigmas) - 2)
        high_idx = low_idx + 1
        low, high = log_sigmas[low_idx], log_sigmas[high_idx]
        w = np.clip((low - log_sigma) / (low - high), 0, 1)
        return (1 - w) * low_idx + w * high_idx

    ts = np.array([sigma_to_t(s) for s in k_sigmas]).round()
    return np.flip(ts).astype(np.int64)


@register_scheduler("DPMSolverMultistepScheduler")
class DPMSolverMultistepScheduler(ConfigurableScheduler):
    config_class = DPMSolverConfig
    init_noise_sigma = 1.0

    def _normalize_config(self, config):
        # a sibling family's values map to this family's defaults; unknown ones fail loudly
        if config.algorithm_type not in ("dpmsolver", "dpmsolver++"):
            if config.algorithm_type != "deis":
                raise NotImplementedError(
                    f"algorithm_type {config.algorithm_type!r} is not implemented for DPMSolverMultistepScheduler"
                )
            config = dataclasses.replace(config, algorithm_type="dpmsolver++")
        if config.solver_type not in ("midpoint", "heun"):
            if config.solver_type not in ("logrho", "bh1", "bh2"):
                raise NotImplementedError(
                    f"solver_type {config.solver_type!r} is not implemented for DPMSolverMultistepScheduler"
                )
            config = dataclasses.replace(config, solver_type="midpoint")
        return config

    def create_state(self) -> DPMSolverState:
        return multistep_state_init(DPMSolverState, self.config)

    def set_timesteps(self, state: DPMSolverState, num_inference_steps: int) -> DPMSolverState:
        if self.config.use_karras_sigmas:
            ts = karras_timesteps(state.schedule.alphas_cumprod.numpy(), num_inference_steps)
            _, unique_idx = np.unique(ts, return_index=True)
            ts = ts[np.sort(unique_idx)].astype(np.int32)
        else:
            ts = multistep_timesteps(self.config.num_train_timesteps, num_inference_steps)
        return dataclasses.replace(state, timesteps=ts, num_inference_steps=len(ts))

    def begin_sampling(self, state: DPMSolverState, sample: torch.Tensor) -> DPMSolverState:
        return dataclasses.replace(state, model_outputs=(), lower_order_nums=0)

    def scale_model_input(self, state, sample, step_index=None):
        return sample

    def convert_model_output(self, state: DPMSolverState, model_output, t: int, sample):
        cfg = self.config
        space = "x0" if cfg.algorithm_type == "dpmsolver++" else "epsilon"
        return convert_multistep_model_output(cfg, space, sample, model_output, state.schedule.alphas_cumprod[t])

    def _first_order(self, state, m0, t, prev_t, sample):
        lam_t, lam_s = state.lambda_t[prev_t], state.lambda_t[t]
        a_t, a_s = state.alpha_t[prev_t], state.alpha_t[t]
        s_t, s_s = state.sigma_t[prev_t], state.sigma_t[t]
        h = lam_t - lam_s
        if self.config.algorithm_type == "dpmsolver++":
            return (s_t / s_s) * sample - (a_t * (torch.exp(-h) - 1.0)) * m0
        return (a_t / a_s) * sample - (s_t * (torch.exp(h) - 1.0)) * m0

    def _second_order(self, state, m0, m1, t_s0, t_s1, prev_t, sample):
        lam_t, lam_s0, lam_s1 = state.lambda_t[prev_t], state.lambda_t[t_s0], state.lambda_t[t_s1]
        a_t, a_s0 = state.alpha_t[prev_t], state.alpha_t[t_s0]
        s_t, s_s0 = state.sigma_t[prev_t], state.sigma_t[t_s0]
        h, h_0 = lam_t - lam_s0, lam_s0 - lam_s1
        r0 = h_0 / h
        D0, D1 = m0, (1.0 / r0) * (m0 - m1)
        if self.config.algorithm_type == "dpmsolver++":
            x = (s_t / s_s0) * sample - (a_t * (torch.exp(-h) - 1.0)) * D0
            if self.config.solver_type == "midpoint":
                return x - 0.5 * (a_t * (torch.exp(-h) - 1.0)) * D1
            return x + (a_t * ((torch.exp(-h) - 1.0) / h + 1.0)) * D1
        x = (a_t / a_s0) * sample - (s_t * (torch.exp(h) - 1.0)) * D0
        if self.config.solver_type == "midpoint":
            return x - 0.5 * (s_t * (torch.exp(h) - 1.0)) * D1
        return x - (s_t * ((torch.exp(h) - 1.0) / h - 1.0)) * D1

    def _third_order(self, state, m0, m1, m2, t_s0, t_s1, t_s2, prev_t, sample):
        lam_t = state.lambda_t[prev_t]
        lam_s0, lam_s1, lam_s2 = state.lambda_t[t_s0], state.lambda_t[t_s1], state.lambda_t[t_s2]
        a_t, a_s0 = state.alpha_t[prev_t], state.alpha_t[t_s0]
        s_t, s_s0 = state.sigma_t[prev_t], state.sigma_t[t_s0]
        h, h_0, h_1 = lam_t - lam_s0, lam_s0 - lam_s1, lam_s1 - lam_s2
        r0, r1 = h_0 / h, h_1 / h
        D0 = m0
        D1_0, D1_1 = (1.0 / r0) * (m0 - m1), (1.0 / r1) * (m1 - m2)
        D1 = D1_0 + (r0 / (r0 + r1)) * (D1_0 - D1_1)
        D2 = (1.0 / (r0 + r1)) * (D1_0 - D1_1)
        if self.config.algorithm_type == "dpmsolver++":
            return (
                (s_t / s_s0) * sample
                - (a_t * (torch.exp(-h) - 1.0)) * D0
                + (a_t * ((torch.exp(-h) - 1.0) / h + 1.0)) * D1
                - (a_t * ((torch.exp(-h) - 1.0 + h) / h**2 - 0.5)) * D2
            )
        return (
            (a_t / a_s0) * sample
            - (s_t * (torch.exp(h) - 1.0)) * D0
            - (s_t * ((torch.exp(h) - 1.0) / h - 1.0)) * D1
            - (s_t * ((torch.exp(h) - 1.0 - h) / h**2 - 0.5)) * D2
        )

    def step(
        self,
        state: DPMSolverState,
        model_output: torch.Tensor,
        step_index: int,
        sample: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[DPMSolverState, torch.Tensor, torch.Tensor]:
        return multistep_solver_step(self, state, model_output, step_index, sample)

    def add_noise(self, state: DPMSolverState, original, noise, timesteps):
        return add_noise_common(state.schedule.alphas_cumprod, original, noise, timesteps)
