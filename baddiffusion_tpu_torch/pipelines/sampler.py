"""The reverse-diffusion loops (port of
``baddiffusion_tpu/pipelines/sampler.py``), with BadDiffusion's hooks:

  (a) ``init``           — start from a caller-supplied latent
                           (how ``noise + trigger`` activates the backdoor)
  (b) ``clip_each_step`` — clamp x_t to ±range after every step
  (c) ``capture_every``  — strided trajectory ("movie") capture; the final
                           step always lands in the last slot
  (d) ``start_from``     — skip the first k timesteps

The JAX chains are ``lax.scan`` programs; here they are Python loops of
eager steps, and a step draws noise only when it uses it. The noise comes
from ``noise_source(k)`` when given (the tests inject the JAX package's own
draws, in the order its key splits make them), else from ``generator``:
``k`` is the step index for the generic chain and Karras-VE, and for SDE-VE
it counts ``correct_steps`` corrector draws, then one predictor draw, per
step. The timestep tables go to the device once, without blocking, so a
chain on the card makes no synchronising call.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from baddiffusion_tpu_torch.schedulers.karras_ve import sample_karras_ve

NoiseSource = Callable[[int], torch.Tensor]
ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def to_device(values, device: torch.device) -> torch.Tensor:
    """A host table on ``device``; to the card through pinned memory,
    without blocking the host."""
    t = torch.as_tensor(values)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def noise_drawer(init: torch.Tensor, generator: Optional[torch.Generator],
                 noise_source: Optional[NoiseSource]) -> Callable[[int], torch.Tensor]:
    """``k -> noise`` of init's shape, dtype and device: from ``noise_source``
    when given, else a fresh draw from ``generator``."""
    if noise_source is not None:
        return lambda k: noise_source(k).to(device=init.device, dtype=init.dtype)
    if generator is None:
        raise ValueError("a chain that draws noise needs a generator or a noise_source")
    return lambda k: torch.randn(init.shape, generator=generator, device=init.device, dtype=init.dtype)


def chain_prologue(scheduler, state, init: torch.Tensor):
    """What happens once before the chain: init-noise scaling (a number, or
    a function of the state) and the scheduler's begin-sampling hook.
    Returns ``(sample, state)``."""
    init_sigma = getattr(scheduler, "init_noise_sigma", 1.0)
    if callable(init_sigma):
        init_sigma = init_sigma(state)
    sample = init * torch.as_tensor(init_sigma, dtype=init.dtype)
    if hasattr(scheduler, "begin_sampling"):
        state = scheduler.begin_sampling(state, sample)
    return sample, state


def movie_frames(n_steps: int, capture_every: Optional[int], init: torch.Tensor) -> Optional[torch.Tensor]:
    if not capture_every:
        return None
    return torch.zeros((-(-n_steps // capture_every),) + tuple(init.shape), dtype=init.dtype, device=init.device)


def sample_loop(
    scheduler,
    state,
    model_fn: ModelFn,
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
    n = len(state.timesteps)
    sample, state = chain_prologue(scheduler, state, init)
    draw = None if generator is None and noise_source is None else noise_drawer(init, generator, noise_source)
    frames = movie_frames(n - start_from, capture_every, init)
    timesteps = to_device(state.timesteps, sample.device)
    for i in range(start_from, n):
        model_in = scheduler.scale_model_input(state, sample, i)
        eps = model_fn(model_in, timesteps[i].expand(sample.shape[0])).to(sample.dtype)
        noise = None
        if scheduler.step_uses_noise(state, i):
            if draw is None:
                raise ValueError("sample_loop needs a generator or a noise_source for this scheduler")
            noise = draw(i)
        state, sample, _ = scheduler.step(state, eps, i, sample, noise)
        if clip_each_step is not None:
            sample = torch.clamp(sample, -clip_each_step, clip_each_step)
        off = i - start_from
        if capture_every and (off % capture_every == 0 or i == n - 1):
            frames[off // capture_every] = sample
    return sample, frames


def sample_sde_ve(
    scheduler,
    state,
    model_fn: ModelFn,
    init: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    noise_source: Optional[NoiseSource] = None,
    capture_every: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The SDE-VE predictor-corrector loop: per timestep, ``correct_steps``
    Langevin corrector steps, then one predictor step; the model sees σ_t.
    Returns the last step's ``sample_mean`` and the movie of the means (the
    last frame the result), or None."""
    n = len(state.timesteps)
    correct_steps = scheduler.config.correct_steps
    sample = init * torch.as_tensor(scheduler.init_noise_sigma, dtype=init.dtype)
    draw = noise_drawer(init, generator, noise_source)
    frames = movie_frames(n, capture_every, init)
    sigmas = to_device(state.sigmas, sample.device)
    mean = None
    for i in range(n):
        sigma_t = sigmas[i].expand(sample.shape[0])
        for j in range(correct_steps):
            score = model_fn(sample, sigma_t).to(sample.dtype)
            sample = scheduler.step_correct(state, score, sample, draw(i * (correct_steps + 1) + j))
        score = model_fn(sample, sigma_t).to(sample.dtype)
        _, sample, mean = scheduler.step_pred(state, score, i, sample, draw(i * (correct_steps + 1) + correct_steps))
        if capture_every and (i % capture_every == 0 or i == n - 1):
            frames[i // capture_every] = mean
    return mean, frames


def sample_chain(
    scheduler,
    state,
    model_fn: ModelFn,
    init: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    noise_source: Optional[NoiseSource] = None,
    start_from: int = 0,
    clip_each_step: Optional[float] = None,
    capture_every: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The chain of any scheduler: SDE-VE and Karras-VE run their own
    engines (SDE-VE ignores ``start_from`` and ``clip_each_step``, Karras-VE
    too), the rest ``sample_loop``. Returns (sample, movie) before the
    mapping to images (``chain_images``)."""
    name = scheduler.hf_class_name
    if name == "KarrasVeScheduler":
        return sample_karras_ve(scheduler, state, model_fn, init, noise_drawer(init, generator, noise_source),
                                capture_every=capture_every)
    if name == "ScoreSdeVeScheduler":
        return sample_sde_ve(scheduler, state, model_fn, init, generator, noise_source, capture_every)
    return sample_loop(scheduler, state, model_fn, init, generator, noise_source, start_from, clip_each_step,
                       capture_every)


def chain_images(scheduler, sample: torch.Tensor) -> torch.Tensor:
    """A chain's result as [0, 1] images: SDE-VE's mean is already in image
    space and is clipped; the others are mapped from [-1, 1]."""
    if scheduler.hf_class_name == "ScoreSdeVeScheduler":
        return torch.clamp(sample, 0.0, 1.0)
    return to_images(sample)


def to_images(sample: torch.Tensor) -> torch.Tensor:
    """[-1, 1] model space → [0, 1] image space."""
    return torch.clamp(sample / 2.0 + 0.5, 0.0, 1.0)


def pad_batch_for_mesh(x: torch.Tensor, count: int) -> Tuple[torch.Tensor, int]:
    """Pad ``x`` with copies of row 0 so that its batch divides ``count``
    data ranks; returns ``(padded, pad)``. ``trim_padded`` drops the rows."""
    pad = (-x.shape[0]) % count
    if pad:
        x = torch.cat([x, x[:1].expand((pad,) + tuple(x.shape[1:]))])
    return x, pad


def trim_padded(images: torch.Tensor, movie: Optional[torch.Tensor], batch_size: int):
    """Drop the padding rows (the movie's batch is its second axis:
    ``[frames, batch, ...]``)."""
    return images[:batch_size], None if movie is None else movie[:, :batch_size]
