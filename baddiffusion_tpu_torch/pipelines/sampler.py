"""The reverse-diffusion loop (port of the DDPM part of
``baddiffusion_tpu/pipelines/sampler.py``), with BadDiffusion's hooks:

  (a) ``init``           — start from a caller-supplied latent
                           (how ``noise + trigger`` activates the backdoor)
  (b) ``clip_each_step`` — clamp x_t to ±range after every step
  (c) ``capture_every``  — strided trajectory ("movie") capture; the final
                           step always lands in the last slot
  (d) ``start_from``     — skip the first k timesteps

The JAX chain is one ``lax.scan`` program; here it is a Python loop of eager
steps. Each step's noise comes from ``noise_source(step_index)`` when given
(the tests inject the JAX package's own draws), else from ``generator``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

NoiseSource = Callable[[int], torch.Tensor]


def chain_prologue(scheduler, state, init: torch.Tensor):
    """What happens once before the chain: init-noise scaling. Returns
    ``(sample, state)``."""
    return init * scheduler.init_noise_sigma, state


def sample_loop(
    scheduler,
    state,
    model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    init: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    noise_source: Optional[NoiseSource] = None,
    start_from: int = 0,
    clip_each_step: Optional[float] = None,
    capture_every: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the reverse chain from ``init``; returns (final_sample, movie).

    ``state`` must already carry inference timesteps (``set_timesteps``).
    ``movie`` is ``[n_frames, *init.shape]``: every ``capture_every``-th
    sample after a step, the final sample in the last frame; or None.
    """
    if generator is None and noise_source is None:
        raise ValueError("sample_loop needs a generator or a noise_source")
    n = len(state.timesteps)
    n_steps = n - start_from
    sample, state = chain_prologue(scheduler, state, init)
    frames = None
    if capture_every:
        frames = torch.zeros((-(-n_steps // capture_every),) + tuple(init.shape), dtype=init.dtype, device=init.device)
    timesteps = torch.as_tensor(state.timesteps, device=sample.device)
    for i in range(start_from, n):
        model_in = scheduler.scale_model_input(state, sample, i)
        eps = model_fn(model_in, timesteps[i].expand(sample.shape[0])).to(sample.dtype)
        if noise_source is not None:
            noise = noise_source(i).to(device=sample.device, dtype=eps.dtype)
        else:
            noise = torch.randn(sample.shape, generator=generator, device=sample.device, dtype=eps.dtype)
        state, sample, _ = scheduler.step(state, eps, i, sample, noise)
        if clip_each_step is not None:
            sample = torch.clamp(sample, -clip_each_step, clip_each_step)
        off = i - start_from
        if capture_every and (off % capture_every == 0 or i == n - 1):
            frames[off // capture_every] = sample
    return sample, frames


def to_images(sample: torch.Tensor) -> torch.Tensor:
    """[-1, 1] model space → [0, 1] image space."""
    return torch.clamp(sample / 2.0 + 0.5, 0.0, 1.0)
