"""The BadDiffusion attack objective (port of ``baddiffusion_tpu/attack/loss.py``).

  q_sample:  x_t = √ᾱ_t·x₀ + √(1−ᾱ_t)·ε + (1−√ᾱ_t)·R
  target:    ε̂* = R_coef_t·R + ε
  R_coef_t = (1−√α_t)·√(1−ᾱ_t) / (1−α_t)

R is the residual (the trigger-stamped image on poison rows, zeros on clean
rows, so clean rows reduce to the plain DDPM loss) and x₀ the training
target (the backdoor target on poison rows, the image itself on clean rows).
The loss is l1, l2 or huber between the UNet's ε-prediction and ε̂*, a mean
over all elements in f32.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def _bcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (like.dim() - 1)).to(like.dtype)


def q_sample_backdoor(
    alphas: torch.Tensor,
    alphas_cumprod: torch.Tensor,
    x_start: torch.Tensor,
    R: torch.Tensor,
    timesteps: torch.Tensor,
    noise: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x_noisy, training_target)."""
    acp_t = alphas_cumprod[timesteps]
    a_t = alphas[timesteps]
    sqrt_acp = _bcast(torch.sqrt(acp_t), x_start)
    sqrt_one_minus_acp = _bcast(torch.sqrt(1.0 - acp_t), x_start)
    r_coef = _bcast((1.0 - torch.sqrt(a_t)) * torch.sqrt(1.0 - acp_t) / (1.0 - a_t), x_start)

    x_noisy = sqrt_acp * x_start + sqrt_one_minus_acp * noise + (1.0 - sqrt_acp) * R
    target = r_coef * R + noise
    return x_noisy, target


def reduce_loss(pred: torch.Tensor, target: torch.Tensor, loss_type: str = "l2") -> torch.Tensor:
    """l1 / l2 / huber (smooth-l1 with beta 1), mean over all elements, in f32."""
    diff = pred.float() - target.float()
    if loss_type == "l2":
        return torch.mean(torch.square(diff))
    if loss_type == "l1":
        return torch.mean(torch.abs(diff))
    if loss_type == "huber":
        absd = torch.abs(diff)
        return torch.mean(torch.where(absd < 1.0, 0.5 * torch.square(diff), absd - 0.5))
    raise NotImplementedError(f"loss_type {loss_type!r}")


def backdoor_loss(
    model_fn: Callable,
    alphas: torch.Tensor,
    alphas_cumprod: torch.Tensor,
    x_start: torch.Tensor,
    R: torch.Tensor,
    timesteps: torch.Tensor,
    noise: torch.Tensor,
    loss_type: str = "l2",
) -> torch.Tensor:
    """q-sample → UNet ε-prediction → reduction. ``model_fn(x, t) -> eps_pred``
    (the JAX form's ``apply_fn(params, x, t)``: the module holds its params)."""
    x_noisy, target = q_sample_backdoor(alphas, alphas_cumprod, x_start, R, timesteps, noise)
    return reduce_loss(model_fn(x_noisy, timesteps), target, loss_type)
