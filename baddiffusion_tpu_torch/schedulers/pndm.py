"""PNDM: a Runge-Kutta (PRK) warm-up, then linear multistep (PLMS) (port of
``baddiffusion_tpu/schedulers/pndm.py``): the timestep construction with the
PRK doubling, both values of ``skip_prk_steps``, the 1st–4th-order PLMS
combinations and formula (9) of arXiv 2202.09778. The state machine runs as
plain branches on the step index and the ring's length."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from baddiffusion_tpu_torch.schedulers.base import (
    ConfigurableScheduler,
    DiffusionSchedule,
    add_noise_common,
    push_ring,
    register_scheduler,
)

PNDM_ORDER = 4


@dataclasses.dataclass(frozen=True)
class PNDMConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "linear"
    trained_betas: Optional[tuple] = None
    skip_prk_steps: bool = False
    set_alpha_to_one: bool = False
    prediction_type: str = "epsilon"
    steps_offset: int = 0


@dataclasses.dataclass(frozen=True)
class PNDMState:
    schedule: DiffusionSchedule
    timesteps: np.ndarray  # [prk + plms] int32
    num_inference_steps: int
    prk_len: int = 0
    ets: Optional[Tuple[torch.Tensor, ...]] = None  # model outputs, newest last
    cur_model_output: Optional[torch.Tensor] = None  # the PRK accumulation
    cur_sample: Optional[torch.Tensor] = None


@register_scheduler("PNDMScheduler")
class PNDMScheduler(ConfigurableScheduler):
    config_class = PNDMConfig
    init_noise_sigma = 1.0

    def create_state(self) -> PNDMState:
        T = self.config.num_train_timesteps
        return PNDMState(
            schedule=DiffusionSchedule.create(self.config),
            timesteps=np.arange(T)[::-1].copy().astype(np.int32),
            num_inference_steps=T,
        )

    def set_timesteps(self, state: PNDMState, num_inference_steps: int) -> PNDMState:
        cfg = self.config
        T = cfg.num_train_timesteps
        step_ratio = T // num_inference_steps
        _ts = (np.arange(0, num_inference_steps) * step_ratio).round() + cfg.steps_offset
        if cfg.skip_prk_steps:
            prk = np.array([])
            plms = np.concatenate([_ts[:-1], _ts[-2:-1], _ts[-1:]])[::-1].copy()
        else:
            prk_ts = np.array(_ts[-PNDM_ORDER:]).repeat(2) + np.tile(
                np.array([0, T // num_inference_steps // 2]), PNDM_ORDER
            )
            prk = (prk_ts[:-1].repeat(2)[1:-1])[::-1].copy()
            plms = _ts[:-3][::-1].copy()
        ts = np.concatenate([prk, plms]).astype(np.int32)
        if ts.size and ts.max() >= T:
            raise ValueError(
                f"steps_offset={cfg.steps_offset} pushes timestep {int(ts.max())} past "
                f"num_train_timesteps={T}; lower num_inference_steps or steps_offset"
            )
        return dataclasses.replace(state, timesteps=ts, num_inference_steps=num_inference_steps, prk_len=len(prk))

    def begin_sampling(self, state: PNDMState, sample: torch.Tensor) -> PNDMState:
        return dataclasses.replace(state, ets=(), cur_model_output=None, cur_sample=None)

    def scale_model_input(self, state, sample, step_index=None):
        return sample

    def _get_prev_sample(self, state: PNDMState, sample, t: int, prev_t: int, model_output):
        acp = state.schedule.alphas_cumprod
        alpha_prod_t = acp[t]
        if prev_t >= 0:
            alpha_prod_t_prev = acp[prev_t]
        else:
            alpha_prod_t_prev = torch.tensor(1.0) if self.config.set_alpha_to_one else acp[0]
        beta_prod_t = 1.0 - alpha_prod_t
        beta_prod_t_prev = 1.0 - alpha_prod_t_prev

        if self.config.prediction_type == "v_prediction":
            model_output = (alpha_prod_t**0.5) * model_output + (beta_prod_t**0.5) * sample
        elif self.config.prediction_type != "epsilon":
            raise ValueError(self.config.prediction_type)

        sample_coeff = (alpha_prod_t_prev / alpha_prod_t) ** 0.5
        denom = alpha_prod_t * beta_prod_t_prev**0.5 + (alpha_prod_t * beta_prod_t * alpha_prod_t_prev) ** 0.5
        return sample_coeff * sample - (alpha_prod_t_prev - alpha_prod_t) * model_output / denom

    def step(
        self,
        state: PNDMState,
        model_output: torch.Tensor,
        step_index: int,
        sample: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[PNDMState, torch.Tensor, torch.Tensor]:
        cfg = self.config
        if state.ets is None:
            state = self.begin_sampling(state, sample)
        T_ratio = cfg.num_train_timesteps // state.num_inference_steps
        i = step_index
        t = int(state.timesteps[i])
        m = model_output

        if i < state.prk_len:
            # PRK: four calls per step; the 1st pushes the ring and starts the
            # accumulation, the 4th uses it
            r = i % 4
            prev_t = t - (T_ratio // 2 if i % 2 == 0 else 0)
            t_used = int(state.timesteps[(i // 4) * 4])
            cur_sample = sample if r == 0 else state.cur_sample
            ets = state.ets
            if r == 0:
                model_used, cur_out, ets = m, m / 6.0, push_ring(ets, m, PNDM_ORDER)
            elif r == 3:
                model_used, cur_out = state.cur_model_output + m / 6.0, None
            else:
                model_used, cur_out = m, state.cur_model_output + m / 3.0
            prev_sample = self._get_prev_sample(state, cur_sample, t_used, prev_t, model_used)
            state = dataclasses.replace(state, ets=ets, cur_model_output=cur_out, cur_sample=cur_sample)
            return state, prev_sample, m

        # PLMS; with skip_prk_steps, step 1 re-evaluates step 0's point
        if cfg.skip_prk_steps and i == 1:
            e1 = state.ets[-1]
            prev_sample = self._get_prev_sample(state, state.cur_sample, t + T_ratio, t, (m + e1) / 2.0)
            return state, prev_sample, m
        ets = push_ring(state.ets, m, PNDM_ORDER)
        e = ets[::-1]
        if len(ets) == 1:
            plms_model = m
        elif len(ets) == 2:
            plms_model = (3.0 * e[0] - e[1]) / 2.0
        elif len(ets) == 3:
            plms_model = (23.0 * e[0] - 16.0 * e[1] + 5.0 * e[2]) / 12.0
        else:
            plms_model = (55.0 * e[0] - 59.0 * e[1] + 37.0 * e[2] - 9.0 * e[3]) / 24.0
        cur_sample = sample if (len(ets) == 1 and i == 0) else state.cur_sample
        prev_sample = self._get_prev_sample(state, sample, t, t - T_ratio, plms_model)
        state = dataclasses.replace(state, ets=ets, cur_sample=cur_sample)
        return state, prev_sample, m

    def add_noise(self, state: PNDMState, original, noise, timesteps):
        return add_noise_common(state.schedule.alphas_cumprod, original, noise, timesteps)
