"""Plain deterministic DDIM for the reference: Song et al. 2020 (arXiv
2010.02502), eq. (12) at σ = 0 (η = 0), over the scheduler configuration's β
table, written from the paper and the diffusers-0.16 ``DDIMScheduler``
configuration keys it names (not from the measured package).

- β: ``scaled_linear`` (linear in √β from √beta_start to √beta_end, squared,
  as latent diffusion trains) or ``linear``; ᾱ_t = ∏_{s≤t} (1 − β_s).
- Timesteps: n steps "leading" from ``num_train_timesteps // n`` apart,
  ``(arange(n) · T//n)`` descending, plus ``steps_offset``; a step goes from t
  to t − T//n, and past the first timestep ᾱ_prev is 1 where
  ``set_alpha_to_one`` says so, else ᾱ_0.
- The step: x₀ = (x_t − √(1 − ᾱ_t)·ε) / √ᾱ_t, x_prev = √ᾱ_prev·x₀ +
  √(1 − ᾱ_prev)·ε.

Departure: the tables are computed in float64 and used in f32 (diffusers
computes β in f32); the two part in the last bits of ᾱ.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


class DDIM:
    """ᾱ in float64 from the scheduler configuration ``cfg`` (the published
    ``scheduler_config.json`` keys)."""

    def __init__(self, cfg: Dict):
        steps = cfg["num_train_timesteps"]
        if cfg["beta_schedule"] == "scaled_linear":
            betas = np.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5, steps, dtype=np.float64) ** 2
        elif cfg["beta_schedule"] == "linear":
            betas = np.linspace(cfg["beta_start"], cfg["beta_end"], steps, dtype=np.float64)
        else:
            raise NotImplementedError(f"reference DDIM: beta_schedule={cfg['beta_schedule']!r}")
        self.T = steps
        self.acp = np.cumprod(1.0 - betas)
        self.final = 1.0 if cfg.get("set_alpha_to_one", True) else float(self.acp[0])
        self.offset = cfg.get("steps_offset", 0)

    def timesteps(self, n: int) -> np.ndarray:
        """The n timesteps of a chain, descending."""
        return (np.arange(n) * (self.T // n))[::-1] + self.offset

    def step(self, x: torch.Tensor, eps: torch.Tensor, t: int, n: int) -> Tuple[torch.Tensor, float]:
        """(x at the next timestep, the step's coefficient k on ε) from x_t
        and the ε-prediction in a chain of ``n`` steps: x_prev moves by −k·δ
        when ε moves by δ."""
        acp_t = float(self.acp[t])
        prev = t - self.T // n
        acp_prev = float(self.acp[prev]) if prev >= 0 else self.final
        x0_coef, eps_coef = acp_prev ** 0.5 / acp_t ** 0.5, (1.0 - acp_prev) ** 0.5
        x0 = (x - (1.0 - acp_t) ** 0.5 * eps) / acp_t ** 0.5
        return acp_prev ** 0.5 * x0 + eps_coef * eps, x0_coef * (1.0 - acp_t) ** 0.5 - eps_coef
