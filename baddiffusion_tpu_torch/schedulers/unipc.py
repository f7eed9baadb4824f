"""UniPC multistep predictor-corrector (port of
``baddiffusion_tpu/schedulers/unipc.py``): the UniP B(h) predictor and UniC
B(h) corrector in their bh1/bh2 variants, the corrector applied from the
second step with the previous step's ring and order, ``disable_corrector``,
the order warm-up and ``lower_order_final``.

The small systems R·ρ = b behind the order-k coefficients are built and
solved on the host in float64 (``numpy.linalg.solve``), and ρ is cast to f32
once. The JAX package solves them in f32 with Cramer's rule (it had to avoid
``jnp.linalg.solve`` inside a compiled chain), which loses precision when two
``rks`` nearly coincide; the port has no such constraint.
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
    convert_multistep_model_output,
    multistep_state_init,
    multistep_timesteps,
    push_ring,
    register_scheduler,
)


@dataclasses.dataclass(frozen=True)
class UniPCConfig:
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
    predict_x0: bool = True
    solver_type: str = "bh2"
    lower_order_final: bool = True
    disable_corrector: tuple = ()


@dataclasses.dataclass(frozen=True)
class UniPCState:
    schedule: DiffusionSchedule
    alpha_t: torch.Tensor
    sigma_t: torch.Tensor
    lambda_t: torch.Tensor
    timesteps: np.ndarray
    num_inference_steps: int
    model_outputs: Optional[Tuple[torch.Tensor, ...]] = None  # newest last
    timestep_ring: Tuple[int, ...] = ()  # their timesteps
    lower_order_nums: int = 0
    last_sample: Optional[torch.Tensor] = None
    this_order: int = 1  # the order chosen at the previous step


def unipc_system(rks: np.ndarray, hh: float, solver_type: str) -> Tuple[np.ndarray, np.ndarray]:
    """R and b of UniPC's k×k system in float64, k = len(rks): R[i] = rks**i
    and b[i] = h·φ_{i+1}(h)·(i+1)!/B(h), the φ_k by their recursion. The
    predictor of order k solves it over its k − 1 rks, the corrector over
    its k − 1 rks and 1."""
    order = len(rks)
    B_h = hh if solver_type == "bh1" else np.expm1(hh)
    R = np.stack([rks**i for i in range(order)])
    b = np.empty(order)
    h_phi_k = np.expm1(hh) / hh - 1.0
    factorial_i = 1.0
    for i in range(1, order + 1):
        b[i - 1] = h_phi_k * factorial_i / B_h
        factorial_i *= i + 1
        h_phi_k = h_phi_k / hh - 1.0 / factorial_i
    return R, b


def solve_rhos(R: np.ndarray, b: np.ndarray) -> torch.Tensor:
    """ρ of R·ρ = b, solved in float64, as f32."""
    return torch.from_numpy(np.linalg.solve(R, b).astype(np.float32))


@register_scheduler("UniPCMultistepScheduler")
class UniPCMultistepScheduler(ConfigurableScheduler):
    config_class = UniPCConfig
    init_noise_sigma = 1.0

    def _normalize_config(self, config):
        # sibling solver families map to bh1; anything else fails loudly
        if config.solver_type not in ("bh1", "bh2"):
            if config.solver_type not in ("midpoint", "heun", "logrho"):
                raise NotImplementedError(
                    f"solver_type {config.solver_type!r} is not implemented for UniPCMultistepScheduler"
                )
            return dataclasses.replace(config, solver_type="bh1")
        return config

    def create_state(self) -> UniPCState:
        return multistep_state_init(UniPCState, self.config)

    def set_timesteps(self, state: UniPCState, num_inference_steps: int) -> UniPCState:
        ts = multistep_timesteps(self.config.num_train_timesteps, num_inference_steps)
        return dataclasses.replace(state, timesteps=ts, num_inference_steps=len(ts))

    def begin_sampling(self, state: UniPCState, sample: torch.Tensor) -> UniPCState:
        return dataclasses.replace(state, model_outputs=(), timestep_ring=(), lower_order_nums=0,
                                   last_sample=None, this_order=1)

    def scale_model_input(self, state, sample, step_index=None):
        return sample

    def convert_model_output(self, state: UniPCState, model_output, t: int, sample):
        cfg = self.config
        space = "x0" if cfg.predict_x0 else "epsilon"
        return convert_multistep_model_output(cfg, space, sample, model_output, state.schedule.alphas_cumprod[t])

    def _coeffs(self, state: UniPCState, ring_t, t_target: int, order: int):
        """h·φ₁(h), B(h), the rks (f32, as the JAX package computes them) and
        hh = ∓h in float64, for the system of the order."""
        lam_s0 = state.lambda_t[ring_t[-1]]
        h = state.lambda_t[t_target] - lam_s0
        rks = [(state.lambda_t[ring_t[-(i + 1)]] - lam_s0) / h for i in range(1, order)]
        hh = -h if self.config.predict_x0 else h
        B_h = hh if self.config.solver_type == "bh1" else torch.expm1(hh)
        return torch.expm1(hh), B_h, rks, float(hh)

    def _rhos(self, rks, hh: float, corrector: bool) -> torch.Tensor:
        """ρ of the predictor's system (the rks) or the corrector's (the rks
        and 1), solved in float64."""
        nodes = [float(r) for r in rks] + ([1.0] if corrector else [])
        return solve_rhos(*unipc_system(np.array(nodes), hh, self.config.solver_type))

    def _update(self, state, ring_m, ring_t, t_target: int, x, h_phi_1, B_h, res):
        """x_t = (σ_t/σ_s0)·x − α_t·h·φ₁·m0 − α_t·B(h)·res (x₀ prediction),
        or its ε counterpart."""
        s0, m0 = ring_t[-1], ring_m[-1]
        if self.config.predict_x0:
            a_t, s_t, s_s0 = state.alpha_t[t_target], state.sigma_t[t_target], state.sigma_t[s0]
            x_t_ = s_t / s_s0 * x - a_t * h_phi_1 * m0
            return x_t_ if res is None else x_t_ - a_t * B_h * res
        a_t, a_s0, s_t = state.alpha_t[t_target], state.alpha_t[s0], state.sigma_t[t_target]
        x_t_ = a_t / a_s0 * x - s_t * h_phi_1 * m0
        return x_t_ if res is None else x_t_ - s_t * B_h * res

    def _uni_p(self, state, ring_m, ring_t, t_target: int, x, order: int):
        """UniP B(h) predictor of the given order."""
        h_phi_1, B_h, rks, hh = self._coeffs(state, ring_t, t_target, order)
        if order == 1:
            return self._update(state, ring_m, ring_t, t_target, x, h_phi_1, B_h, None)
        rhos = torch.tensor([0.5]) if order == 2 else self._rhos(rks, hh, corrector=False)
        m0 = ring_m[-1]
        res = sum(rhos[k] * ((ring_m[-(k + 2)] - m0) / rks[k]) for k in range(order - 1))
        return self._update(state, ring_m, ring_t, t_target, x, h_phi_1, B_h, res)

    def _uni_c(self, state, ring_m, ring_t, model_t, t_target: int, last_x, order: int):
        """UniC B(h) corrector of the given order; the ring is the previous
        step's (m0 is the previous model output)."""
        h_phi_1, B_h, rks, hh = self._coeffs(state, ring_t, t_target, order)
        rhos = torch.tensor([0.5]) if order == 1 else self._rhos(rks, hh, corrector=True)
        m0 = ring_m[-1]
        corr = sum(rhos[k] * ((ring_m[-(k + 2)] - m0) / rks[k]) for k in range(order - 1))
        res = corr + rhos[order - 1] * (model_t - m0)
        return self._update(state, ring_m, ring_t, t_target, last_x, h_phi_1, B_h, res)

    def step(
        self,
        state: UniPCState,
        model_output: torch.Tensor,
        step_index: int,
        sample: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[UniPCState, torch.Tensor, torch.Tensor]:
        cfg = self.config
        if state.model_outputs is None:
            state = self.begin_sampling(state, sample)
        n = len(state.timesteps)
        i = step_index
        t = int(state.timesteps[i])
        prev_t = 0 if i == n - 1 else int(state.timesteps[i + 1])

        converted = self.convert_model_output(state, model_output, t, sample)
        # the corrector uses the previous ring and the previous step's order
        if i > 0 and (i - 1) not in cfg.disable_corrector:
            sample = self._uni_c(state, state.model_outputs, state.timestep_ring, converted, t,
                                 state.last_sample, state.this_order)

        ring_m = push_ring(state.model_outputs, converted, cfg.solver_order)
        ring_t = push_ring(state.timestep_ring, t, cfg.solver_order)
        this_order = min(cfg.solver_order, n - i) if cfg.lower_order_final else cfg.solver_order
        this_order = min(this_order, state.lower_order_nums + 1)
        prev_sample = self._uni_p(state, ring_m, ring_t, prev_t, sample, this_order)

        state = dataclasses.replace(
            state, model_outputs=ring_m, timestep_ring=ring_t,
            lower_order_nums=min(state.lower_order_nums + 1, cfg.solver_order),
            last_sample=sample, this_order=this_order,
        )
        return state, prev_sample, converted

    def add_noise(self, state: UniPCState, original, noise, timesteps):
        return add_noise_common(state.schedule.alphas_cumprod, original, noise, timesteps)
