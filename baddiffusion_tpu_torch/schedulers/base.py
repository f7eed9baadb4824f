"""Scheduler core (port of ``baddiffusion_tpu/schedulers/base.py``):
β-tables, the timestep spacings, the shared step math of the multistep
solver family, and the HF-layout ``scheduler_config.json`` round trip.

The α/β tables are f32 tensors, indexed by timestep, and every per-step
coefficient is computed from them in f32 as the JAX package does — Python
floats (f64) would drift from it. They live on the host: a step's
coefficients are 0-dim f32 tensors that PyTorch passes to the device kernels
as scalars, so the scalar math costs no device launches and no
synchronisation.

The chain is a Python loop with a Python-int step index, so where the JAX
package selects branchlessly among every order's update (``jnp.where`` in a
scan body), a step here computes only the update it selects, and ring
buffers are tuples of tensors.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, Optional, Tuple, Type

import numpy as np
import torch

SCHEDULER_CONFIG_NAME = "scheduler_config.json"
QUANTILE_MAX_ELEMENTS = 1 << 24  # torch.quantile's input-size limit


def make_betas(
    beta_schedule: str,
    beta_start: float,
    beta_end: float,
    num_train_timesteps: int,
    trained_betas=None,
    max_beta: float = 0.999,
) -> np.ndarray:
    """β-table (linear / scaled_linear / squaredcos_cap_v2 / sigmoid), float32."""
    if trained_betas is not None:
        return np.asarray(trained_betas, dtype=np.float32)
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float32)
    if beta_schedule == "scaled_linear":
        return (
            np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float32) ** 2
        ).astype(np.float32)
    if beta_schedule == "squaredcos_cap_v2":
        # alpha_bar(t) = cos((t + 0.008) / 1.008 * pi/2)^2  (Glide cosine schedule)
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

        betas = []
        for i in range(num_train_timesteps):
            t1 = i / num_train_timesteps
            t2 = (i + 1) / num_train_timesteps
            betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
        return np.asarray(betas, dtype=np.float32)
    if beta_schedule == "sigmoid":
        betas = 1.0 / (1.0 + np.exp(-np.linspace(-6, 6, num_train_timesteps)))
        return (betas * (beta_end - beta_start) + beta_start).astype(np.float32)
    raise NotImplementedError(f"beta_schedule {beta_schedule!r} is not implemented")


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """The α/β tables every discrete-time scheduler carries: [T] f32 host tensors."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor

    @classmethod
    def create(cls, config) -> "DiffusionSchedule":
        betas = make_betas(
            config.beta_schedule,
            config.beta_start,
            config.beta_end,
            config.num_train_timesteps,
            getattr(config, "trained_betas", None),
        )
        alphas = (1.0 - betas).astype(np.float32)
        alphas_cumprod = np.cumprod(alphas, dtype=np.float32)
        return cls(
            betas=torch.from_numpy(betas),
            alphas=torch.from_numpy(alphas),
            alphas_cumprod=torch.from_numpy(alphas_cumprod),
        )


def spaced_timesteps(num_train_timesteps: int, num_inference_steps: int) -> np.ndarray:
    """'leading'-spaced descending inference timesteps: round(arange(n) * T//n)[::-1]."""
    if num_inference_steps > num_train_timesteps:
        raise ValueError(
            f"num_inference_steps {num_inference_steps} > num_train_timesteps {num_train_timesteps}"
        )
    step_ratio = num_train_timesteps // num_inference_steps
    return (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int32)


def multistep_timesteps(num_train_timesteps: int, num_inference_steps: int) -> np.ndarray:
    """'linspace'-spaced descending timesteps with order-preserving dedupe:
    the multistep solver family's spacing (DPM-Solver, UniPC, DEIS)."""
    ts = (
        np.linspace(0, num_train_timesteps - 1, num_inference_steps + 1)
        .round()[::-1][:-1]
        .astype(np.int64)
    )
    _, unique_idx = np.unique(ts, return_index=True)
    return ts[np.sort(unique_idx)].astype(np.int32)


def kdiffusion_sigma_table(alphas_cumprod: np.ndarray, num_inference_steps: int, num_train_timesteps: int):
    """The k-diffusion σ table shared by Heun and K-LMS: float timesteps
    linspaced over the training range (descending) and σ(t) = √((1−ᾱ)/ᾱ)
    interpolated onto them, 0-terminated. Returns (timesteps f64, σ f32)."""
    ts = np.linspace(0, num_train_timesteps - 1, num_inference_steps, dtype=float)[::-1].copy()
    sigmas = ((1 - alphas_cumprod) / alphas_cumprod) ** 0.5
    sigmas = np.interp(ts, np.arange(0, len(sigmas)), sigmas)
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    return ts, sigmas


def add_noise_common(alphas_cumprod: torch.Tensor, original: torch.Tensor, noise: torch.Tensor,
                     timesteps: torch.Tensor) -> torch.Tensor:
    """q(x_t | x_0): √ᾱ_t·x₀ + √(1−ᾱ_t)·ε, per sample."""
    acp = alphas_cumprod.to(original.device)[timesteps.to(original.device).long()].to(original.dtype)
    acp = acp.reshape((-1,) + (1,) * (original.dim() - 1))
    return torch.sqrt(acp) * original + torch.sqrt(1.0 - acp) * noise


def get_velocity_common(alphas_cumprod: torch.Tensor, sample: torch.Tensor, noise: torch.Tensor,
                        timesteps: torch.Tensor) -> torch.Tensor:
    """v-prediction target: √ᾱ_t·ε − √(1−ᾱ_t)·x₀, per sample."""
    acp = alphas_cumprod.to(sample.device)[timesteps.to(sample.device).long()].to(sample.dtype)
    acp = acp.reshape((-1,) + (1,) * (sample.dim() - 1))
    return torch.sqrt(acp) * noise - torch.sqrt(1.0 - acp) * sample


def multistep_state_init(state_cls, config):
    """The multistep family's state: the schedule and α_t = √ᾱ, σ_t = √(1−ᾱ),
    λ_t = log α − log σ tables. These are derived in float64 and cast to f32
    once, as the JAX package does: λ reaches about −10 under squaredcos, and
    the solvers' exp(λ_s − λ_t) coefficients amplify table rounding by up to
    ~1.6e3 on the first step, so f32-derived logs cost several ulps there
    (3e-2 of the final sample on squaredcos chains). ``state_cls`` supplies
    any further fields through their defaults."""
    schedule = DiffusionSchedule.create(config)
    acp = schedule.alphas_cumprod.numpy().astype(np.float64)
    alpha_t = np.sqrt(acp)
    sigma_t = np.sqrt(1.0 - acp)
    lambda_t = np.log(alpha_t) - np.log(sigma_t)
    T = config.num_train_timesteps
    return state_cls(
        schedule=schedule,
        alpha_t=torch.from_numpy(alpha_t.astype(np.float32)),
        sigma_t=torch.from_numpy(sigma_t.astype(np.float32)),
        lambda_t=torch.from_numpy(lambda_t.astype(np.float32)),
        timesteps=np.arange(T)[::-1].copy().astype(np.int32),
        num_inference_steps=T,
    )


def push_ring(ring: Tuple[torch.Tensor, ...], item, size: int) -> tuple:
    """A ring buffer as a tuple, newest last, at most ``size`` long."""
    return (ring + (item,))[-size:]


def multistep_solver_step(solver, state, model_output: torch.Tensor, step_index: int, sample: torch.Tensor):
    """The ring + warm-up + order selection shared by DPM-Solver and DEIS:
    push the converted model output, pick the order (the warm-up counter caps
    it; ``lower_order_final`` forces the tail on short chains), and compute
    that order's update only. ``solver`` supplies ``convert_model_output``
    and ``_first_order`` / ``_second_order`` / ``_third_order``."""
    cfg = solver.config
    if state.model_outputs is None:
        state = solver.begin_sampling(state, sample)
    ts = state.timesteps
    n = len(ts)
    i = step_index
    t = int(ts[i])
    prev_t = 0 if i == n - 1 else int(ts[i + 1])
    t_s1, t_s2 = int(ts[max(i - 1, 0)]), int(ts[max(i - 2, 0)])

    converted = solver.convert_model_output(state, model_output, t, sample)
    ring = push_ring(state.model_outputs, converted, cfg.solver_order)

    lon = state.lower_order_nums
    lower_final = cfg.lower_order_final and n < 15
    if cfg.solver_order == 1 or lon < 1 or (lower_final and i == n - 1):
        prev_sample = solver._first_order(state, ring[-1], t, prev_t, sample)
    elif cfg.solver_order == 2 or lon < 2 or (lower_final and i == n - 2):
        prev_sample = solver._second_order(state, ring[-1], ring[-2], t, t_s1, prev_t, sample)
    else:
        prev_sample = solver._third_order(state, ring[-1], ring[-2], ring[-3], t, t_s1, t_s2, prev_t, sample)

    state = dataclasses.replace(state, model_outputs=ring, lower_order_nums=min(lon + 1, cfg.solver_order))
    return state, prev_sample, converted


def threshold_sample(sample: torch.Tensor, ratio: float, max_value: float) -> torch.Tensor:
    """Imagen dynamic thresholding: per sample, clip to the ``ratio`` quantile
    of |x| (at least 1, at most ``max_value``) and divide by it."""
    batch = sample.shape[0]
    flat = sample.reshape(batch, -1).abs().float()
    if flat.numel() <= QUANTILE_MAX_ELEMENTS:
        s = torch.quantile(flat, ratio, dim=1)
    else:  # one row at a time stays under torch.quantile's size limit
        s = torch.stack([torch.quantile(row, ratio) for row in flat])
    s = torch.clamp(s, 1.0, max_value).reshape((batch,) + (1,) * (sample.dim() - 1))
    return (torch.clamp(sample, -s, s) / s).to(sample.dtype)


def convert_multistep_model_output(cfg, output_space: str, sample: torch.Tensor, model_output: torch.Tensor,
                                   alpha_prod_t: torch.Tensor) -> torch.Tensor:
    """The solver family's model-output conversion:

    - ``'x0'``: data-space prediction, dynamically thresholded when
      configured (DPM-Solver++, UniPC with predict_x0);
    - ``'epsilon'``: noise-space prediction, never thresholded;
    - ``'x0_to_epsilon'``: threshold in data space, then back to noise space
      (DEIS: its ε is that of the thresholded x₀).
    """
    x0, eps = pred_x0_from_model_output(cfg.prediction_type, sample, model_output, alpha_prod_t)
    if output_space == "epsilon":
        return eps
    if cfg.thresholding:
        x0 = threshold_sample(x0, cfg.dynamic_thresholding_ratio, cfg.sample_max_value)
    if output_space == "x0":
        return x0
    if output_space != "x0_to_epsilon":
        raise ValueError(f"unknown output_space {output_space!r}")
    return (sample - alpha_prod_t**0.5 * x0) / (1.0 - alpha_prod_t) ** 0.5


def pred_x0_from_model_output(
    prediction_type: str,
    sample: torch.Tensor,
    model_output: torch.Tensor,
    alpha_prod_t: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pred_original_sample, pred_epsilon) for 'epsilon' | 'sample' | 'v_prediction'."""
    beta_prod_t = 1.0 - alpha_prod_t
    sqrt_a = alpha_prod_t**0.5
    sqrt_b = beta_prod_t**0.5
    if prediction_type == "epsilon":
        x0 = (sample - sqrt_b * model_output) / sqrt_a
        eps = model_output
    elif prediction_type == "sample":
        x0 = model_output
        eps = (sample - sqrt_a * x0) / sqrt_b
    elif prediction_type == "v_prediction":
        x0 = sqrt_a * sample - sqrt_b * model_output
        eps = sqrt_a * model_output + sqrt_b * sample
    else:
        raise ValueError(f"unknown prediction_type {prediction_type!r}")
    return x0, eps


# ---------------------------------------------------------------------------
# Config (de)serialization, HF layout (``scheduler_config.json``)
# ---------------------------------------------------------------------------

_SCHEDULER_REGISTRY: Dict[str, Type] = {}


def register_scheduler(hf_class_name: str):
    """Class decorator: register a scheduler under its HF ``_class_name``."""

    def wrap(cls):
        _SCHEDULER_REGISTRY[hf_class_name] = cls
        cls.hf_class_name = hf_class_name
        return cls

    return wrap


def scheduler_registry() -> Dict[str, Type]:
    return dict(_SCHEDULER_REGISTRY)


class ConfigurableScheduler:
    """Base for schedulers: a frozen-dataclass config plus its json round
    trip. A scheduler is immutable and compares by its class and config."""

    config_class: Type = None
    hf_class_name: str = None
    order: int = 1

    def __init__(self, config=None, **kwargs):
        if config is None:
            config = self.config_class(**kwargs)
        elif kwargs:
            config = dataclasses.replace(config, **kwargs)
        self.config = self._normalize_config(config)

    def _normalize_config(self, config):
        """Subclass hook: coerce a sibling family's config values, reject
        unknown ones at construction."""
        return config

    def __eq__(self, other):
        return type(self) is type(other) and self.config == other.config

    def __hash__(self):
        return hash((type(self).__name__, self.config))

    def step_uses_noise(self, state, step_index: int) -> bool:
        """Whether ``step`` at ``step_index`` adds noise, so the chain draws
        it only then."""
        return False

    def save_config(self, save_directory: str) -> None:
        os.makedirs(save_directory, exist_ok=True)
        payload = {"_class_name": self.hf_class_name, "_diffusers_version": "0.16.0.dev0"}
        payload.update(dataclasses.asdict(self.config))
        payload = {k: (list(v) if isinstance(v, tuple) else v) for k, v in payload.items()}
        with open(os.path.join(save_directory, SCHEDULER_CONFIG_NAME), "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)

    save_pretrained = save_config

    @classmethod
    def from_config_dict(cls, payload: Dict[str, Any]) -> "ConfigurableScheduler":
        fields = {f.name for f in dataclasses.fields(cls.config_class)}
        # json turns tuples into lists; convert back so configs stay hashable
        kwargs = {k: (tuple(v) if isinstance(v, list) else v) for k, v in payload.items() if k in fields}
        return cls(cls.config_class(**kwargs))

    @classmethod
    def from_pretrained(cls, path: str, subfolder: Optional[str] = None) -> "ConfigurableScheduler":
        if subfolder:
            path = os.path.join(path, subfolder)
        if os.path.isdir(path):
            path = os.path.join(path, SCHEDULER_CONFIG_NAME)
        with open(path) as f:
            payload = json.load(f)
        if cls is ConfigurableScheduler:
            klass = _SCHEDULER_REGISTRY.get(payload.get("_class_name"))
            if klass is None:
                raise ValueError(
                    f"unknown scheduler class {payload.get('_class_name')!r}; known: {sorted(_SCHEDULER_REGISTRY)}"
                )
            return klass.from_config_dict(payload)
        return cls.from_config_dict(payload)


def load_scheduler(path: str, subfolder: Optional[str] = None) -> ConfigurableScheduler:
    """Load any registered scheduler from an HF-layout ``scheduler_config.json``."""
    return ConfigurableScheduler.from_pretrained(path, subfolder=subfolder)
