"""The command line: train / resume / sampling / measure / train+measure (port
of ``baddiffusion_tpu/cli.py``).

The reference's ``baddiffusion.py`` dispatch (:651-679) and its mode bodies:
train_loop (:572-645), sampling (:366-419), measure (:477-551) with
``score.json`` merging (:428-450). Run with

    python -m baddiffusion_tpu_torch.cli --mode train --dataset CIFAR10 --batch 128 ...

(the JAX package's flag surface; ``config.py`` has the per-mode rules). It
runs on the card unless ``--gpu cpu`` asks for the CPU. One process drives
one device: the JAX package's mesh, FSDP, model-parallel and multi-process
branches are not ported (ROADMAP Queue 1 item 11), and a run that asks for
them raises.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from baddiffusion_tpu_torch import factory
from baddiffusion_tpu_torch.config import (
    MODE_MEASURE,
    MODE_RESUME,
    MODE_SAMPLING,
    MODE_TRAIN,
    MODE_TRAIN_MEASURE,
    TrainingConfig,
    setup,
)
from baddiffusion_tpu_torch.data import DatasetLoader
from baddiffusion_tpu_torch.metrics import fid as fid_fn
from baddiffusion_tpu_torch.metrics import mse as mse_fn
from baddiffusion_tpu_torch.metrics import ssim as ssim_fn
from baddiffusion_tpu_torch.metrics import using_real_weights
from baddiffusion_tpu_torch.pipelines import batch_sampling_save
from baddiffusion_tpu_torch.training import (
    create_train_state,
    ep_model_path,
    has_trainer_state,
    load_trainer_state,
    make_optimizer,
    make_train_step,
    sample_grids,
    train_loop,
)
from baddiffusion_tpu_torch.utils.image import load_image_dir, save_images
from baddiffusion_tpu_torch.utils.logging import Log
from baddiffusion_tpu_torch.utils.trackers import Tracker


def check_single_device(config) -> None:
    """Refuse what needs more than one process or device (ROADMAP Queue 1
    item 11), and ``--sample_segment``, which has no meaning here."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError("multi-process runs are not ported yet (ROADMAP Queue 1 item 11)")
    if getattr(config, "model_parallel", 1) > 1 or getattr(config, "param_sharding", "replicated") == "fsdp":
        raise NotImplementedError("--model_parallel > 1 and --param_sharding fsdp shard over a device mesh, "
                                  "which is not ported yet (ROADMAP Queue 1 item 11)")
    if getattr(config, "sample_segment", None):
        raise ValueError("--sample_segment bounds the length of an XLA sampling program in the JAX package; "
                         "an eager chain has no program to bound, so the flag has no meaning here")


def get_data_loader(config: TrainingConfig) -> DatasetLoader:
    """The loader yields global batches (``--batch`` × grad-accum): the
    train step splits them into ``--batch``-row micro-batches, as the
    reference accumulates loader batches."""
    global_batch = config.batch * config.gradient_accumulation_steps
    dsl = DatasetLoader(
        config.dataset,
        root=config.dataset_path,
        batch_size=global_batch,
        seed=config.seed,
        fake_size=config.fake_size,
        image_size=config.image_size,
    )
    dsl.set_poison(
        trigger_type=config.trigger,
        target_type=config.target,
        clean_rate=config.clean_rate,
        poison_rate=config.poison_rate,
    ).prepare_dataset(mode=config.dataset_load_mode, split_method=config.split_method)
    return dsl


def init_model(config: TrainingConfig, dsl: DatasetLoader):
    """(model, scheduler, get_pipeline) for the configured ckpt, on the run's
    device: f32 compute with ``mixed_precision == "no"``, else bf16 compute
    on f32 parameters."""
    dtype = torch.float32 if config.mixed_precision == "no" else torch.bfloat16
    if config.ckpt is None:
        return factory.get_model_sched(
            image_size=dsl.image_size,
            channels=dsl.channel,
            noise_sched_type=config.sched,
            clip_sample=config.clip,
            rng_seed=config.seed,
            dtype=dtype,
            device=config.device,
        )
    return factory.get_pretrained(config.ckpt, clip_sample=config.clip, noise_sched_type=config.sched, dtype=dtype,
                                  device=config.device)


def run_train(config: TrainingConfig, resume: bool = False) -> DatasetLoader:
    """Train (or resume) the run; returns the loader, so that train+measure
    does not decode and split the dataset a second time."""
    check_single_device(config)
    device = config.device
    dsl = get_data_loader(config)
    model, scheduler, get_pipeline = init_model(config, dsl)
    schedule = scheduler.create_state().schedule

    # the reference steps its LR schedule once a micro-batch (warmup 500,
    # len(loader)·epochs in all); here it steps once an optimizer step, so
    # both constants scale by 1/grad-accum to trace the same curve
    accum = max(1, config.gradient_accumulation_steps)
    optimizer, lr_schedule = make_optimizer(
        config.learning_rate,
        num_warmup_steps=max(1, config.lr_warmup_steps // accum),
        num_training_steps=max(1, config.epoch * dsl.num_batch),
    )
    state = create_train_state(model, optimizer, dsl.trigger, dsl.target, dsl.mask)
    start_epoch = start_step = 0
    if resume and has_trainer_state(config.output_dir):
        state, start_epoch, start_step = load_trainer_state(config.output_dir, state)
        Log.info(f"resumed from epoch {start_epoch}, step {start_step}")

    train_step = make_train_step(
        model,
        optimizer,
        scheduler.config.num_train_timesteps,
        schedule.alphas,
        schedule.alphas_cumprod,
        grad_accum=config.gradient_accumulation_steps,
        # "auto" is the JAX package's rule: recompute only at 256 px above micro-batch 16
        use_remat={"on": True, "off": False}.get(config.remat, dsl.image_size >= 256 and config.batch > 16),
        device=device,
    )

    def make_pipeline(st):
        return get_pipeline(scheduler, device=device)

    tracker = Tracker(
        os.path.join(config.output_dir, "logs"),
        project=config.project,
        run_name=os.path.basename(config.output_dir),
        config=vars(config),
    )
    try:
        train_loop(
            dsl=dsl,
            train_step=train_step,
            state=state,
            lr_schedule=lr_schedule,
            epochs=config.epoch,
            tracker=tracker,
            out_dir=config.output_dir,
            make_pipeline=make_pipeline,
            seed=config.seed,
            start_epoch=start_epoch,
            start_step=start_step,
            save_image_epochs=config.save_image_epochs,
            save_model_epochs=config.save_model_epochs,
            sample_n=config.eval_sample_n,
            sampling_steps=config.sampling_steps,
            save_all_model_epochs=config.is_save_all_model_epochs,
            capture_every=config.capture_every,
            profile_steps=config.profile_steps,
            async_ckpt=config.async_ckpt,
        )
    finally:
        tracker.close()
    return dsl


def load_pipeline_for_eval(config: TrainingConfig):
    """The run dir's pipeline (or an epoch's snapshot, ``--sample_ep``) on the
    run's device. The UNet computes in f32, as the reference samples and
    measures with its unwrapped f32 model, unless ``--eval_dtype bf16``."""
    path = config.output_dir
    if config.sample_ep is not None:
        path = ep_model_path(config.output_dir, config.sample_ep)
    _model, scheduler, get_pipeline = factory.get_trained(
        path, clip_sample=config.clip, noise_sched_type=config.sched, dtype=torch.float32, device=config.device
    )
    pipeline = get_pipeline(scheduler, device=config.device)
    if config.eval_dtype == "bf16":
        pipeline.compute_dtype = torch.bfloat16
    return pipeline


def run_sampling(config: TrainingConfig, dsl: Optional[DatasetLoader] = None) -> None:
    check_single_device(config)
    dsl = dsl or get_data_loader(config)
    pipeline = load_pipeline_for_eval(config)
    tag = f"{config.sample_ep}" if config.sample_ep is not None else "final"
    tag += "" if config.clip else "_noclip"
    steps = config.sampling_steps or pipeline.default_inference_steps
    sample_grids(
        pipeline,
        dsl.trigger,
        config.output_dir,
        tag,
        sample_n=config.eval_sample_n,
        num_inference_steps=steps,
        seed=config.seed,
        capture_every=config.capture_every,
    )
    Log.info(f"sampling written under {config.output_dir}/(samples|backdoor_samples)")


def update_score_file(config: TrainingConfig, score_file: str, fid_sc, mse_sc, ssim_sc, fid_key: str = "FID") -> dict:
    """Merge scores under FID/MSE/SSIM[_ep{n}][_noclip] keys (reference
    baddiffusion.py:428-450). ``fid_key`` is ``FID_proxy`` when the extractor
    is the offline proxy: its scores are not comparable with pytorch-fid's
    and never take the bare ``FID`` key."""

    def get_key(key: str) -> str:
        res = f"{key}_ep{config.sample_ep}" if config.sample_ep is not None else key
        res += "_noclip" if not config.clip else ""
        return res

    path = os.path.join(config.output_dir, score_file)
    sc = {}
    if os.path.exists(path):
        with open(path) as f:
            sc = json.load(f)
    for key, val in ((fid_key, fid_sc), ("MSE", mse_sc), ("SSIM", ssim_sc)):
        k = get_key(key)
        sc[k] = val if val is not None else sc.get(k)
    with open(path, "w") as f:
        json.dump(sc, f, indent=2, sort_keys=True)
    return sc


def measure_noise(seed: int, shape, device: torch.device) -> torch.Tensor:
    """The measure's initial noise: a draw from a generator on ``device``
    seeded ``seed`` (the JAX package draws ``jax.random.normal(PRNGKey(seed))``,
    which the tests hand in here)."""
    return torch.randn(shape, generator=torch.Generator(device).manual_seed(seed), device=device)


def target_images(dsl: DatasetLoader) -> np.ndarray:
    """The backdoor target as an HWC image in [0, 1]."""
    return np.clip(dsl.target / 2.0 + 0.5, 0, 1)


def run_measure(config: TrainingConfig, dsl: Optional[DatasetLoader] = None, resample: bool = True,
                recomp: bool = True) -> None:
    """FID (clean generations against real images) and MSE/SSIM (backdoor
    generations against the tiled target), reference measure()
    (baddiffusion.py:477-551). The real-image dump is cwd-relative
    (``measure/<dataset>``); the generations go to
    ``<run>/measure[/ep{n}]/clean|backdoor[_noclip]``."""
    check_single_device(config)
    device = config.device
    dsl = dsl or get_data_loader(config)
    pipeline = load_pipeline_for_eval(config)

    dataset_img_dir = os.path.join("measure", config.dataset)
    folder_parts = [config.output_dir, "measure"]
    if config.sample_ep is not None:
        folder_parts.append(f"ep{config.sample_ep}")
    suffix = "" if config.clip else "_noclip"
    clean_path = os.path.join(*folder_parts, "clean" + suffix)
    backdoor_path = os.path.join(*folder_parts, "backdoor" + suffix)

    recomp_clean = recomp_backdoor = recomp
    if not os.path.isdir(dataset_img_dir):
        # membership matches the reference's ds.shuffle(seed)[:n] dump
        # (baddiffusion.py:489,503-508): DatasetLoader.real_image_sample
        imgs01 = dsl.real_image_sample(config.measure_sample_n).astype(np.float32) / 255.0
        save_images(imgs01, dataset_img_dir)
        recomp_clean = True

    noise = measure_noise(config.seed, pipeline.sample_shape(config.measure_sample_n), device)
    backdoor_noise = noise + torch.as_tensor(dsl.trigger, dtype=torch.float32, device=device)[None]

    need_clean = resample or not os.path.isdir(clean_path)
    need_backdoor = resample or not os.path.isdir(backdoor_path)
    steps_kw = {} if config.measure_steps is None else {"num_inference_steps": config.measure_steps}
    if need_clean:
        batch_sampling_save(config.measure_sample_n, pipeline, clean_path, init=noise,
                            max_batch_n=config.eval_max_batch, seed=config.seed, **steps_kw)
        recomp_clean = True
    if need_backdoor:
        batch_sampling_save(config.measure_sample_n, pipeline, backdoor_path, init=backdoor_noise,
                            max_batch_n=config.eval_max_batch, seed=config.seed, **steps_kw)
        recomp_backdoor = True

    fid_sc = mse_sc = ssim_sc = None
    if recomp_clean:
        fid_sc = float(fid_fn([dataset_img_dir, clean_path], device=device))
    if recomp_backdoor:
        gen = load_image_dir(backdoor_path)
        tiled = np.ascontiguousarray(np.broadcast_to(target_images(dsl), gen.shape))
        mse_sc = float(mse_fn(gen, tiled, device=device))
        ssim_sc = float(ssim_fn(gen, tiled, device=device))
    Log.info(f"[{config.sample_ep}] FID: {fid_sc}, MSE: {mse_sc}, SSIM: {ssim_sc}")

    fid_key = "FID" if using_real_weights() else "FID_proxy"
    sc = update_score_file(config, "score.json", fid_sc, mse_sc, ssim_sc, fid_key=fid_key)
    tracker = Tracker(os.path.join(config.output_dir, "logs"), project=config.project)
    # the reference logs micro-steps (baddiffusion.py:452-475); the loader
    # yields global batches, so scale by grad-accum
    epochs_done = config.sample_ep + 1 if config.sample_ep is not None else config.epoch
    step = dsl.num_batch * max(1, config.gradient_accumulation_steps) * epochs_done
    tracker.log({k: v for k, v in sc.items() if v is not None}, step=step)
    tracker.close()


def main(argv=None) -> None:
    config = setup(argv)
    if config.mode in (MODE_TRAIN, MODE_RESUME, MODE_TRAIN_MEASURE):
        dsl = run_train(config, resume=config.mode == MODE_RESUME)
        if config.mode == MODE_TRAIN_MEASURE:
            run_measure(config, dsl=dsl)
    elif config.mode == MODE_SAMPLING:
        run_sampling(config)
    elif config.mode == MODE_MEASURE:
        run_measure(config)
    else:
        raise NotImplementedError(config.mode)


if __name__ == "__main__":
    main()
