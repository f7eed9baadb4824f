"""Training orchestration: the crash-tolerant epoch loop and its sample
grids (port of ``baddiffusion_tpu/training/trainer.py``).

The reference's ``train_loop``: the loss logged per step, 4×4 sample grids
every ``save_image_epochs``, a checkpoint every ``save_model_epochs`` and at
the end, and the whole loop wrapped so that any exception still
checkpoints before it propagates. The grids: one fixed-seed batch sampled
from pure noise into ``samples/`` and from ``noise + trigger`` into
``backdoor_samples/``, each with the grid of the movie's first frame.

Everything runs on the device of the state it is given. The draws of a step
come from a ``torch.Generator`` on that device seeded from ``(seed,
global_step)`` alone (the counterpart of JAX's ``fold_in(key,
global_step)``), so a resumed run draws what an uninterrupted one drew at
the same step.

On several ranks (``layout``, the counterpart of the JAX loop's ``mesh``)
every rank runs the loop: the prefetch stages the rank's rows of each
global batch, a barrier starts the first step on every rank together (the
counterpart of the JAX loop's ``AlignedStep``), the grids gather the
parameters and rank 0 alone samples and writes them, and every rank joins
the checkpoints (``training.checkpoint``). Only a rank with a ``tracker``
logs.

The loop's loss read and each save are the spans ``train.sync_loss`` and
``ckpt.save`` (``utils/profiling.span``), in the ``profile_steps`` trace
with the step's; each save's host seconds also go to the tracker as
``ckpt_stall_s``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch

from baddiffusion_tpu_torch.data.prefetch import device_prefetch
from baddiffusion_tpu_torch.parallel.distributed import barrier, is_primary
from baddiffusion_tpu_torch.training.checkpoint import finish_async_saves, save_checkpoint
from baddiffusion_tpu_torch.utils.image import save_image_grid
from baddiffusion_tpu_torch.utils.logging import Log
from baddiffusion_tpu_torch.utils.profiling import span


def step_seed(seed: int, global_step: int) -> int:
    """The seed of step ``global_step``'s generator: a function of ``(seed,
    global_step)`` alone."""
    hi, lo = np.random.SeedSequence([seed, global_step]).generate_state(2, np.uint32)
    return (int(hi) << 32) | int(lo)


def sample_grids(
    pipeline,
    trigger: Optional[np.ndarray],
    out_dir: str,
    epoch_tag,
    sample_n: int = 16,
    num_inference_steps: int = 1000,
    seed: int = 0,
    with_movie: bool = True,
    capture_every: Optional[int] = None,
    noise=None,
    noise_source=None,
) -> None:
    """Fixed-seed qualitative sampling into ``<out>/samples/ep{tag}.png`` and
    ``<out>/backdoor_samples/ep{tag}.png`` (with ``_t0.png``, the movie's
    first frame, when ``with_movie``).

    The initial noise comes from a generator seeded with ``seed``, or is
    ``noise``; each chain's step noise from a generator seeded with ``seed +
    1``, the same for both chains, or from ``noise_source(step_index)``. The
    backdoor init is the unmasked sum ``noise + trigger``, as the reference
    samples it."""
    device = pipeline.device
    shape = pipeline.sample_shape(sample_n)
    if noise is None:
        noise = torch.randn(shape, generator=torch.Generator(device).manual_seed(seed), device=device)
    noise = torch.as_tensor(noise, dtype=torch.float32, device=device)

    jobs = [("samples", noise)]
    if trigger is not None:
        jobs.append(("backdoor_samples", noise + torch.as_tensor(trigger, dtype=torch.float32, device=device)[None]))

    for sub, init in jobs:
        out = pipeline(
            init=init,
            generator=torch.Generator(device).manual_seed(seed + 1),
            noise_source=noise_source,
            num_inference_steps=num_inference_steps,
            save_every_step=with_movie,
            capture_every=capture_every,  # None: about 50 frames
        )
        d = os.path.join(out_dir, sub)
        os.makedirs(d, exist_ok=True)
        # a square grid of what was sampled (4×4 at the reference's 16)
        g = max(1, int(np.ceil(np.sqrt(len(out.images)))))
        save_image_grid(out.images, os.path.join(d, f"ep{epoch_tag}.png"), rows=g, cols=g)
        if out.movie is not None:
            save_image_grid(out.movie[0], os.path.join(d, f"ep{epoch_tag}_t0.png"), rows=g, cols=g)


def train_loop(
    *,
    dsl,
    train_step: Callable,
    state,
    lr_schedule: Callable,
    epochs: int,
    tracker,
    out_dir: str,
    make_pipeline: Callable[[object], object],
    seed: int = 0,
    start_epoch: int = 0,
    start_step: int = 0,
    save_image_epochs: int = 20,
    save_model_epochs: int = 5,
    sample_n: int = 16,
    sampling_steps: int = 1000,
    save_all_model_epochs: bool = False,
    capture_every: Optional[int] = None,
    log_every: int = 20,
    profile_steps: int = 0,
    async_ckpt: bool = False,
    layout=None,
):
    """Train epochs ``start_epoch`` … ``epochs − 1`` and return ``(state,
    global_step)``. ``train_step(state, image_u8, is_clean, generator)``
    returns ``(state, {"loss": ...})``; ``make_pipeline(state)`` returns the
    pipeline the grids sample from and the HF export saves (given the state
    with whole parameters). ``tracker`` may be None (a rank that does not
    log). Crash-tolerant: the loop checkpoints on the way out unless its last
    checkpoint already holds this step, then re-raises."""
    device = next(iter(state.params.values())).device
    global_step = start_step
    last_saved_step = None
    prof = None

    def checkpoint(epoch: int) -> None:
        nonlocal last_saved_step
        t0 = time.perf_counter()
        with span("ckpt.save"):
            save_checkpoint(out_dir, state, epoch, make_pipeline, save_all_model_epochs, async_save=async_ckpt,
                            layout=layout)
        last_saved_step = global_step
        if tracker is not None:
            tracker.log({"ckpt_stall_s": time.perf_counter() - t0, "epoch": epoch}, step=global_step)

    cur_epoch = start_epoch
    rows = None if layout is None else layout.batch
    barrier("first_step")
    try:
        for epoch in range(start_epoch, epochs):
            cur_epoch = epoch
            batches = dsl.epoch_batches(epoch)
            with contextlib.closing(device_prefetch(batches, device, size=2, rows=rows)) as stream:
                for batch in stream:
                    if profile_steps and global_step == start_step + 2:
                        activities = [torch.profiler.ProfilerActivity.CPU]
                        if device.type == "cuda":
                            activities.append(torch.profiler.ProfilerActivity.CUDA)
                        # every thread: the feed's data.stage spans too
                        every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
                        prof = torch.profiler.profile(activities=activities, experimental_config=every_thread)
                        prof.start()
                    if prof is not None and global_step == start_step + 2 + profile_steps:
                        _stop_profile(prof, device, out_dir)
                        prof = None
                    generator = torch.Generator(device).manual_seed(step_seed(seed, global_step))
                    state, metrics = train_step(state, batch["image_u8"], batch["is_clean"], generator)
                    if tracker is not None and global_step % log_every == 0:
                        with span("train.sync_loss"):
                            loss = float(metrics["loss"])
                        logs = {
                            "loss": loss,
                            "lr": float(lr_schedule(global_step)),
                            "epoch": epoch,
                            "step": global_step,
                        }
                        tracker.log(logs, step=global_step)
                    global_step += 1

            # (epoch + 1) % N, the reference's cadence: no burst right after epoch 0
            if (epoch + 1) % save_image_epochs == 0 or epoch == epochs - 1:
                st = state
                if layout is not None and layout.sharded:  # every rank joins the gather
                    st = dataclasses.replace(state, params=layout.full_params(state.params))
                try:
                    if is_primary():
                        sample_grids(make_pipeline(st), dsl.trigger, out_dir, epoch, sample_n=sample_n,
                                     num_inference_steps=sampling_steps, seed=seed, capture_every=capture_every)
                except Exception:  # the grids are diagnostics: training goes on, as in the reference
                    Log.error("sampling failed:\n" + traceback.format_exc())
                # peers wait for rank 0's grids within the store's bound, not a collective's
                barrier("grids", timeout_s=3600.0)
            if (epoch + 1) % save_model_epochs == 0 or epoch == epochs - 1:
                checkpoint(epoch)
    except KeyboardInterrupt:
        Log.warning("interrupted — checkpointing before exit")
        raise
    except Exception:
        Log.error("training crashed:\n" + traceback.format_exc())
        raise
    finally:
        if prof is not None:  # a run shorter than the profile window
            try:
                _stop_profile(prof, device, out_dir)
            except Exception:  # the original exception, if any, propagates
                Log.error("profiler stop failed:\n" + traceback.format_exc())
        # the reference's save on the way out, unless the last periodic
        # checkpoint already holds this very step
        if last_saved_step != global_step:
            if state.opt_state.count != state.step:
                # the step raised inside the optimizer's in-place update: the
                # parameters and moments may be half updated
                Log.error("cannot checkpoint: the failing step left the state half updated; resume from the "
                          "last periodic checkpoint in " + out_dir)
            else:
                try:
                    checkpoint(cur_epoch)
                except Exception:  # the original exception, if any, propagates
                    Log.error("final checkpoint failed:\n" + traceback.format_exc())
        try:
            finish_async_saves()  # the last async write and its data.json on disk before returning
        except Exception:
            Log.error("async checkpoint finalization failed:\n" + traceback.format_exc())
    return state, global_step


def _stop_profile(prof, device: torch.device, out_dir: str) -> None:
    """Stop the profiler and write its trace to ``<out>/profile/trace.json``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    path = os.path.join(out_dir, "profile", "trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    Log.info(f"profiler trace written to {path}")
