"""The reverse-diffusion loops (port of
``baddiffusion_tpu/pipelines/sampler.py``), with BadDiffusion's hooks:

  (a) ``init``           — start from a caller-supplied latent
                           (how ``noise + trigger`` activates the backdoor)
  (b) ``clip_each_step`` — clamp x_t to ±range after every step
  (c) ``capture_every``  — strided trajectory ("movie") capture; the final
                           step always lands in the last slot
  (d) ``start_from``     — skip the first k timesteps

The JAX chains are ``lax.scan`` programs; here every chain but Karras-VE's
is one ``Chain``: Python loops of eager steps, run whole or in segments
(``pipelines/segments.py`` captures the segments as CUDA graphs), and a
step draws noise only when it uses it. The noise comes
from ``noise_source(k)`` when given (the tests inject the JAX package's own
draws, in the order its key splits make them), else from ``generator``:
``k`` is the step index for the generic chain and Karras-VE, and for SDE-VE
it counts ``correct_steps`` corrector draws, then one predictor draw, per
step. The timestep tables go to the device once, without blocking, so a
chain on the card makes no synchronising call.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from baddiffusion_tpu_torch.schedulers.karras_ve import sample_karras_ve
from baddiffusion_tpu_torch.utils.profiling import span

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


def make_step_once(scheduler, model_fn: ModelFn, timesteps: torch.Tensor, draw: Optional[Callable[[int], torch.Tensor]],
                   clip_each_step: Optional[float]) -> Callable:
    """One reverse-diffusion step as a ``(sample, state, i) -> (sample,
    state)`` transition, shared by the whole chain and the segmented runner.
    ``timesteps`` is the state's table on the sample's device; ``draw(i)``
    gives the step's noise, drawn only when the step uses it. A step is the
    span ``sampler.step`` (``utils/profiling.span``)."""

    def step_once(sample, state, i: int):
        with span("sampler.step"):
            model_in = scheduler.scale_model_input(state, sample, i)
            eps = model_fn(model_in, timesteps[i].expand(sample.shape[0])).to(sample.dtype)
            noise = None
            if scheduler.step_uses_noise(state, i):
                if draw is None:
                    raise ValueError("this scheduler's step draws noise: the chain needs a generator or a noise_source")
                noise = draw(i)
            state, sample, _ = scheduler.step(state, eps, i, sample, noise)
            if clip_each_step is not None:
                sample = torch.clamp(sample, -clip_each_step, clip_each_step)
            return sample, state

    return step_once


def chain_segment(step_once: Callable, sample: torch.Tensor, state, frames: Optional[torch.Tensor], seg_start: int,
                  seg_len: int, total_steps: int, chain_start: int = 0, capture_every: Optional[int] = None):
    """Steps ``[seg_start, seg_start + seg_len)`` of a chain of
    ``total_steps`` that began at ``chain_start``, on the carried
    ``(sample, state, frames)``; returns the carry. A frame is written every
    ``capture_every`` steps from ``chain_start``, and the chain's final step
    always goes into the last slot, so split into any segments the chain
    computes what it computes whole."""
    for i in range(seg_start, seg_start + seg_len):
        sample, state = step_once(sample, state, i)
        off = i - chain_start
        if capture_every and (off % capture_every == 0 or i == total_steps - 1):
            frames[off // capture_every] = sample
    return sample, state, frames


Carry = Tuple[torch.Tensor, Optional[torch.Tensor], object, Optional[torch.Tensor]]  # sample, last_mean, state, frames


class Chain:
    """The one runner of a chain over a state that carries its inference
    timesteps (``set_timesteps``), run whole or in segments: the prologue,
    the dispatch between SDE-VE's predictor-corrector steps and the generic
    step, the movie's frames and the timestep or σ table on the device.
    ``sample_chain`` runs it eagerly; ``pipelines/segments.py`` captures its
    segments as CUDA graphs. SDE-VE runs from step 0 whatever
    ``start_from`` (its engine ignores it, as the JAX package's does); the
    others from ``start_from``. The chain runs every entry of the state's
    timestep table: PNDM's holds more entries than the steps asked for (its
    Runge-Kutta warm-up) and the multistep solvers' may hold fewer."""

    def __init__(self, scheduler, state, device: torch.device, start_from: int = 0,
                 clip_each_step: Optional[float] = None, capture_every: Optional[int] = None):
        self.scheduler = scheduler
        self.state = state
        self.sde_ve = scheduler.hf_class_name == "ScoreSdeVeScheduler"
        self.n = len(state.timesteps)
        self.chain_start = 0 if self.sde_ve else start_from
        self.clip_each_step = clip_each_step
        self.capture_every = capture_every
        # SDE-VE's model sees σ_t; the others the timestep
        self.table = to_device(state.sigmas if self.sde_ve else state.timesteps, device)

    def spans(self, segment_steps: Optional[int] = None) -> List[Tuple[int, int]]:
        """(start, length) of each segment of at most ``segment_steps``
        (None: the whole chain), the last one shorter when ``segment_steps``
        does not divide the chain."""
        size = segment_steps or max(1, self.n - self.chain_start)
        return [(s, min(size, self.n - s)) for s in range(self.chain_start, self.n, size)]

    def start(self, init: torch.Tensor) -> Carry:
        """The prologue: init-noise scaling and the scheduler's
        begin-sampling hook, and the movie's zeroed frames."""
        frames = movie_frames(self.n - self.chain_start, self.capture_every, init)
        if self.sde_ve:
            return init * torch.as_tensor(self.scheduler.init_noise_sigma, dtype=init.dtype), None, self.state, frames
        sample, state = chain_prologue(self.scheduler, self.state, init)
        return sample, None, state, frames

    def run(self, carry: Carry, model_fn: ModelFn, draw: Optional[Callable[[int], torch.Tensor]], seg_start: int,
            seg_len: int) -> Carry:
        """Steps ``[seg_start, seg_start + seg_len)`` on the carry."""
        sample, mean, state, frames = carry
        if self.sde_ve:
            if draw is None:
                raise ValueError("an SDE-VE chain draws noise: it needs a generator or a noise_source")
            return sde_ve_segment(self.scheduler, model_fn, self.table, draw, sample, mean, state, frames,
                                  seg_start, seg_len, self.n, self.capture_every)
        step_once = make_step_once(self.scheduler, model_fn, self.table, draw, self.clip_each_step)
        sample, state, frames = chain_segment(step_once, sample, state, frames, seg_start, seg_len, self.n,
                                              self.chain_start, self.capture_every)
        return sample, None, state, frames

    def result(self, carry: Carry) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(the chain's sample, or SDE-VE's last mean; the movie or None)."""
        sample, mean, _, frames = carry
        return (mean if self.sde_ve else sample), frames

    def run_eager(self, init: torch.Tensor, model_fn: ModelFn, draw: Optional[Callable[[int], torch.Tensor]],
                  segment_steps: Optional[int] = None):
        """The chain from ``init``, whole or in segments of ``segment_steps``
        one after another (the same operations, so the same bits)."""
        carry = self.start(init)
        for s, length in self.spans(segment_steps):
            carry = self.run(carry, model_fn, draw, s, length)
        return self.result(carry)


def sde_ve_segment(scheduler, model_fn: ModelFn, sigmas: torch.Tensor, draw: Callable[[int], torch.Tensor],
                   sample: torch.Tensor, last_mean: Optional[torch.Tensor], state, frames: Optional[torch.Tensor],
                   seg_start: int, seg_len: int, total_steps: int, capture_every: Optional[int] = None):
    """Predictor-corrector steps ``[seg_start, seg_start + seg_len)`` of an
    SDE-VE chain of ``total_steps``, on the carried ``(sample, last_mean,
    state, frames)`` (``last_mean`` is the last predictor step's mean, the
    chain's result; the frames are the means). ``sigmas`` is the state's σ
    table on the sample's device; step i's noise draws are ``draw(i·(c+1) +
    j)``, c = ``correct_steps``: the correctors' j < c, then the predictor's."""
    correct_steps = scheduler.config.correct_steps
    for i in range(seg_start, seg_start + seg_len):
        sigma_t = sigmas[i].expand(sample.shape[0])
        for j in range(correct_steps):
            score = model_fn(sample, sigma_t).to(sample.dtype)
            sample = scheduler.step_correct(state, score, sample, draw(i * (correct_steps + 1) + j))
        score = model_fn(sample, sigma_t).to(sample.dtype)
        state, sample, last_mean = scheduler.step_pred(state, score, i, sample,
                                                       draw(i * (correct_steps + 1) + correct_steps))
        if capture_every and (i % capture_every == 0 or i == total_steps - 1):
            frames[i // capture_every] = last_mean
    return sample, last_mean, state, frames



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
    segment_steps: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The chain of any scheduler from ``init``; returns (sample, movie)
    before the mapping to images (``chain_images``). ``state`` must already
    carry inference timesteps (``set_timesteps``). ``movie`` is
    ``[n_frames, *init.shape]``: every ``capture_every``-th sample after a
    step, the final sample in the last frame; or None. Karras-VE runs its
    own engine; the rest are ``Chain.run_eager``, in segments of
    ``segment_steps`` when given (SDE-VE ignores ``start_from`` and
    ``clip_each_step``, Karras-VE too, and returns its last step's mean)."""
    if scheduler.hf_class_name == "KarrasVeScheduler":
        return sample_karras_ve(scheduler, state, model_fn, init, noise_drawer(init, generator, noise_source),
                                capture_every=capture_every)
    draw = None if generator is None and noise_source is None else noise_drawer(init, generator, noise_source)
    return Chain(scheduler, state, init.device, start_from, clip_each_step, capture_every).run_eager(
        init, model_fn, draw, segment_steps)


def sample_loop(scheduler, state, model_fn: ModelFn, init: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise_source: Optional[NoiseSource] = None, start_from: int = 0,
                clip_each_step: Optional[float] = None, capture_every: Optional[int] = None):
    """The generic reverse chain (the JAX package's ``sample_loop``): ``sample_chain``."""
    return sample_chain(scheduler, state, model_fn, init, generator, noise_source, start_from, clip_each_step,
                        capture_every)


def sample_sde_ve(scheduler, state, model_fn: ModelFn, init: torch.Tensor, generator: Optional[torch.Generator] = None,
                  noise_source: Optional[NoiseSource] = None, capture_every: Optional[int] = None):
    """The SDE-VE predictor-corrector chain (the JAX package's
    ``sample_sde_ve``): per timestep, ``correct_steps`` Langevin corrector
    steps, then one predictor step; the model sees σ_t. Returns the last
    step's ``sample_mean`` and the movie of the means, or None."""
    return sample_chain(scheduler, state, model_fn, init, generator, noise_source, capture_every=capture_every)


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
