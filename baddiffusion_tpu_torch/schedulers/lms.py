"""K-LMS, linear multistep over the σ-ODE (port of
``baddiffusion_tpu/schedulers/lms.py``): the σ-scaled model input, a ring of
up to four derivatives, and the ``[n, 4]`` table of integrated coefficients,
computed once on the host with ``scipy.integrate.quad`` (scipy is imported
only there)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from baddiffusion_tpu_torch.schedulers.base import (
    ConfigurableScheduler,
    DiffusionSchedule,
    kdiffusion_sigma_table,
    push_ring,
    register_scheduler,
)
from baddiffusion_tpu_torch.schedulers.heun import sigma_pred_x0

LMS_ORDER = 4


@dataclasses.dataclass(frozen=True)
class LMSConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "linear"
    trained_betas: Optional[tuple] = None
    prediction_type: str = "epsilon"


@dataclasses.dataclass(frozen=True)
class LMSState:
    schedule: DiffusionSchedule
    timesteps: np.ndarray  # [n] float32
    sigmas: torch.Tensor  # [n+1] f32
    lms_coeffs: torch.Tensor  # [n, 4] f32; entry k multiplies the k-th newest derivative
    num_inference_steps: int
    derivatives: Optional[Tuple[torch.Tensor, ...]] = None  # newest last


def coeff_table(sigmas: np.ndarray, n: int, order: int = LMS_ORDER) -> np.ndarray:
    """The integrated LMS coefficients: row i holds step i's, entry k the
    k-th newest derivative's; unused entries are zero."""
    from scipy import integrate

    table = np.zeros((n, order), np.float32)
    for i in range(n):
        cur_order = min(i + 1, order)
        for k in range(cur_order):

            def lms_derivative(tau, k=k, cur_order=cur_order, i=i):
                prod = 1.0
                for j in range(cur_order):
                    if k == j:
                        continue
                    prod *= (tau - sigmas[i - j]) / (sigmas[i - k] - sigmas[i - j])
                return prod

            table[i, k] = integrate.quad(lms_derivative, sigmas[i], sigmas[i + 1], epsrel=1e-4)[0]
    return table


@register_scheduler("LMSDiscreteScheduler")
class LMSDiscreteScheduler(ConfigurableScheduler):
    config_class = LMSConfig

    @staticmethod
    def init_noise_sigma(state: LMSState) -> torch.Tensor:
        return state.sigmas.max()

    def create_state(self) -> LMSState:
        schedule = DiffusionSchedule.create(self.config)
        acp = schedule.alphas_cumprod.numpy()
        sigmas = np.concatenate([(((1 - acp) / acp) ** 0.5)[::-1], [0.0]]).astype(np.float32)
        T = self.config.num_train_timesteps
        return LMSState(
            schedule=schedule,
            timesteps=np.linspace(0, T - 1, T, dtype=np.float32)[::-1].copy(),
            sigmas=torch.from_numpy(sigmas),
            lms_coeffs=torch.zeros((T, LMS_ORDER)),
            num_inference_steps=T,
        )

    def set_timesteps(self, state: LMSState, num_inference_steps: int) -> LMSState:
        acp = state.schedule.alphas_cumprod.numpy()
        ts, sigmas = kdiffusion_sigma_table(acp, num_inference_steps, self.config.num_train_timesteps)
        return dataclasses.replace(
            state, timesteps=ts.astype(np.float32), sigmas=torch.from_numpy(sigmas),
            lms_coeffs=torch.from_numpy(coeff_table(sigmas, num_inference_steps)),
            num_inference_steps=num_inference_steps,
        )

    def begin_sampling(self, state: LMSState, sample: torch.Tensor) -> LMSState:
        return dataclasses.replace(state, derivatives=())

    def scale_model_input(self, state: LMSState, sample: torch.Tensor, step_index: int) -> torch.Tensor:
        sigma = state.sigmas[step_index]
        return sample / ((sigma**2 + 1.0) ** 0.5)

    def step(
        self,
        state: LMSState,
        model_output: torch.Tensor,
        step_index: int,
        sample: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[LMSState, torch.Tensor, torch.Tensor]:
        if state.derivatives is None:
            state = self.begin_sampling(state, sample)
        sigma = state.sigmas[step_index]
        pred_x0 = sigma_pred_x0(self.config.prediction_type, sample, model_output, sigma)
        ring = push_ring(state.derivatives, (sample - pred_x0) / sigma, LMS_ORDER)
        coeffs = state.lms_coeffs[step_index]
        prev_sample = sample
        for k, derivative in enumerate(reversed(ring)):
            prev_sample = prev_sample + coeffs[k] * derivative
        return dataclasses.replace(state, derivatives=ring), prev_sample, pred_x0

    def add_noise(self, state: LMSState, original, noise, timesteps):
        ts = torch.from_numpy(state.timesteps)
        idx = torch.searchsorted(-ts, -timesteps.cpu().to(ts.dtype))
        sigma = state.sigmas[idx].to(original.device).reshape((-1,) + (1,) * (original.dim() - 1))
        return original + noise * sigma
