"""Score-SDE VE (variance-exploding) predictor-corrector scheduler (port of
``baddiffusion_tpu/schedulers/sde_ve.py``): continuous timesteps
linspace(1, ε, n), geometric σ tables, the reverse-SDE predictor
``step_pred`` and the Langevin corrector ``step_correct``. Both take their
noise as a tensor. The corrector's step size comes from per-sample norms and
stays a device tensor (no synchronisation). The loop that drives them is
``pipelines.sampler.sample_sde_ve``: the model sees σ_t, not t."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from baddiffusion_tpu_torch.schedulers.base import ConfigurableScheduler, register_scheduler


@dataclasses.dataclass(frozen=True)
class ScoreSdeVeConfig:
    num_train_timesteps: int = 2000
    snr: float = 0.15
    sigma_min: float = 0.01
    sigma_max: float = 1348.0
    sampling_eps: float = 1e-5
    correct_steps: int = 1


@dataclasses.dataclass(frozen=True)
class ScoreSdeVeState:
    timesteps: torch.Tensor  # [n] f32, linspace(1, eps, n)
    sigmas: torch.Tensor  # [n] f32
    discrete_sigmas: torch.Tensor  # [n] f32
    num_inference_steps: int


def batch_mean_norm(x: torch.Tensor) -> torch.Tensor:
    """The mean over the batch of each sample's L2 norm, as a 0-dim tensor on
    x's device."""
    return torch.linalg.vector_norm(x.reshape(x.shape[0], -1), dim=-1).mean()


@register_scheduler("ScoreSdeVeScheduler")
class ScoreSdeVeScheduler(ConfigurableScheduler):
    config_class = ScoreSdeVeConfig

    @property
    def init_noise_sigma(self):
        return self.config.sigma_max

    def create_state(self) -> ScoreSdeVeState:
        return self.set_timesteps(None, self.config.num_train_timesteps)

    def set_timesteps(self, state: Optional[ScoreSdeVeState], num_inference_steps: int,
                      sampling_eps: Optional[float] = None) -> ScoreSdeVeState:
        cfg = self.config
        eps = sampling_eps if sampling_eps is not None else cfg.sampling_eps
        ts = np.linspace(1.0, eps, num_inference_steps, dtype=np.float32)
        sigmas = cfg.sigma_min * (cfg.sigma_max / cfg.sigma_min) ** ts  # the exponent is t itself
        discrete = np.exp(np.linspace(math.log(cfg.sigma_min), math.log(cfg.sigma_max), num_inference_steps))
        return ScoreSdeVeState(
            timesteps=torch.from_numpy(ts),
            sigmas=torch.from_numpy(sigmas.astype(np.float32)),
            discrete_sigmas=torch.from_numpy(discrete.astype(np.float32)),
            num_inference_steps=num_inference_steps,
        )

    def scale_model_input(self, state, sample, step_index=None):
        return sample

    def step_pred(
        self,
        state: ScoreSdeVeState,
        model_output: torch.Tensor,
        step_index: int,
        sample: torch.Tensor,
        noise: torch.Tensor,
    ) -> Tuple[ScoreSdeVeState, torch.Tensor, torch.Tensor]:
        """Reverse-SDE predictor. Returns (state, prev_sample, prev_sample_mean)."""
        n = len(state.timesteps)
        ts_idx = int(state.timesteps[step_index] * (n - 1))
        sigma = state.discrete_sigmas[ts_idx]
        adjacent = state.discrete_sigmas[ts_idx - 1] if ts_idx > 0 else torch.tensor(0.0)
        diffusion = (sigma**2 - adjacent**2) ** 0.5
        drift = -(diffusion**2) * model_output
        prev_sample_mean = sample - drift
        return state, prev_sample_mean + diffusion * noise, prev_sample_mean

    def step_correct(
        self,
        state: ScoreSdeVeState,
        model_output: torch.Tensor,
        sample: torch.Tensor,
        noise: torch.Tensor,
    ) -> torch.Tensor:
        """Langevin corrector with the SNR-scaled step size."""
        grad_norm = batch_mean_norm(model_output)
        noise_norm = batch_mean_norm(noise)
        step_size = (self.config.snr * noise_norm / grad_norm) ** 2 * 2.0
        prev_sample_mean = sample + step_size * model_output
        return prev_sample_mean + ((step_size * 2.0) ** 0.5) * noise

    def add_noise(self, state: ScoreSdeVeState, original, noise, timesteps):
        sigmas = state.discrete_sigmas.to(original.device)[timesteps.to(original.device).long()]
        return original + noise * sigmas.reshape((-1,) + (1,) * (original.dim() - 1))
