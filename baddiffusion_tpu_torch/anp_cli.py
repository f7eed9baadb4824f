"""The ANP defense's command line (port of ``baddiffusion_tpu/anp_cli.py``).

The reference's ``anp_defense.py`` and ``anp_config.py``:

    python -m baddiffusion_tpu_torch.anp_cli --ckpt <backdoored run dir> \\
        --perturb_budget 4.0 --epoch 5 --learning_rate 1e-4

Reads the target run's resolved ``config.json`` (then its ``args.json``) for
the trigger, target, dataset and poison rate; loads the dataset fully
poisoned (clean rate 0, poison rate 1, anp_util.py:149); maximises the clean
DDPM loss over the conv perturbation γ/β with a ±budget clamp after each
step, logging ``backdoor_mse``; each epoch samples grids and scores MSE/SSIM
against the backdoor target, with ``*_best`` kept in ``score.json``
(anp_util.py:233-270); at the end the perturbed model is exported in the HF
layout, which both packages load. Output dir
``res_anp_{ep}_lr{lr}_pb{budget}[_sched][_{tag}]_{ckpt}`` (anp_config.py:48-51).

It works on a run dir that either package trained. It runs on the card
unless ``--gpu cpu`` asks for the CPU. Under torchrun (one process a card,
``--gpu`` as in ``cli``) each rank steps on its rows of the batch and the γ/β
gradients are averaged over the ranks, so every rank holds the same
perturbation; rank 0 alone makes the output dir, logs, samples the grids,
measures and exports (the JAX package gathers the perturbation for that; here
rank 0 already holds it), while its peers wait at a barrier.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from baddiffusion_tpu_torch import factory
from baddiffusion_tpu_torch.cli import measure_noise, target_images
from baddiffusion_tpu_torch.config import device_from_gpu, join_ranks, run_dir_handshake
from baddiffusion_tpu_torch.data import DatasetLoader
from baddiffusion_tpu_torch.defense import init_perturb, make_anp_step, perturb_leaves, perturbed_copy
from baddiffusion_tpu_torch.device import resolve_device
from baddiffusion_tpu_torch.metrics import mse as mse_fn
from baddiffusion_tpu_torch.metrics import ssim as ssim_fn
from baddiffusion_tpu_torch.parallel import batch_sharding, make_mesh
from baddiffusion_tpu_torch.parallel.distributed import barrier, is_primary, world_size
from baddiffusion_tpu_torch.pipelines import batch_sampling
from baddiffusion_tpu_torch.training import make_optimizer, sample_grids
from baddiffusion_tpu_torch.training.trainer import step_seed
from baddiffusion_tpu_torch.utils.image import save_images
from baddiffusion_tpu_torch.utils.logging import Log
from baddiffusion_tpu_torch.utils.trackers import Tracker


@dataclass
class ANPConfig:
    project: str = "anp_test"
    dataset_path: str = "datasets"
    dataset: str = "CIFAR10"
    batch: int = 128
    epoch: int = 10
    trigger: str = "NONE"
    target: str = "TRIGGER"
    poison_rate: Optional[float] = None
    ckpt: Optional[str] = None
    clip: bool = True
    learning_rate: float = 1e-4
    lr_sched: bool = False
    perturb_budget: float = 4.0
    tag: Optional[str] = None
    measure_sample_n: int = 128
    eval_sample_n: int = 16
    save_image_epochs: int = 1
    save_model_epochs: int = 5
    output_dir: str = ""
    measure_dir: str = "measure"
    score_file: str = "score.json"
    lr_warmup_steps: int = 500
    seed: int = 0
    fake_size: int = 512
    sampling_steps: int = 1000
    # the per-epoch measure and grids sample in f32 (the reference samples
    # with its unwrapped f32 model); bf16 is opt-in
    eval_dtype: str = "fp32"
    gpu: Optional[str] = None  # device: unset = cuda, N = cuda:N, cpu = the CPU; a list: rank r's r-th entry


def naming_fn(config: ANPConfig) -> str:
    add_on = "_sched" if config.lr_sched else ""
    add_on += f"_{config.tag}" if config.tag else ""
    return f"res_anp_{config.epoch}_lr{config.learning_rate}_pb{config.perturb_budget}{add_on}_{config.ckpt}"


def get_config(argv=None) -> ANPConfig:
    config = ANPConfig()
    parser = argparse.ArgumentParser(description="baddiffusion_tpu_torch ANP defense")
    parser.add_argument("--project", "-pj", type=str)
    parser.add_argument("--epoch", "-e", type=int)
    parser.add_argument("--learning_rate", "-lr", type=float)
    parser.add_argument("--lr_sched", "-sch", action="store_true", default=None)
    parser.add_argument("--perturb_budget", "-pb", type=float)
    parser.add_argument("--output_dir", "-od", type=str)
    parser.add_argument("--tag", "-t", type=str)
    parser.add_argument("--gpu", "-g", type=str, help="device: unset = cuda, N = cuda:N, cpu = the CPU; under "
                        "torchrun a list 0,1 gives rank r its r-th card (0,0: two ranks on one card, over gloo)")
    parser.add_argument("--ckpt", "-c", type=str, required=True)
    parser.add_argument("--batch", "-b", type=int)
    parser.add_argument("--measure_sample_n", type=int)
    parser.add_argument("--sampling_steps", type=int)
    parser.add_argument("--fake_size", type=int)
    parser.add_argument("--eval_dtype", type=str, choices=["fp32", "bf16"])
    args = parser.parse_args(argv)
    for key, value in vars(args).items():
        if value is not None and hasattr(config, key):
            setattr(config, key, value)

    base = args.output_dir or ""
    config.output_dir = os.path.join(base, naming_fn(config)) if base else naming_fn(config)

    # the attack is inherited from the target run (reference anp_config.py:
    # 79-86 reads args.json). args.json holds the raw flags (null where a
    # default was used), so the resolved config.json comes first; a run that
    # records neither raises rather than scoring against the wrong trigger
    run_data = {}
    cfg_path = os.path.join(config.ckpt, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            run_data = json.load(f)
    with open(os.path.join(config.ckpt, "args.json")) as f:
        args_data = json.load(f)
    for key in ("trigger", "target", "dataset"):
        inherited = run_data.get(key) or args_data.get(key)
        if inherited is None:
            raise ValueError(
                f"target run {config.ckpt} records no {key!r} in config.json/"
                "args.json — cannot recover the attack configuration"
            )
        setattr(config, key, inherited)
    config.poison_rate = run_data.get("poison_rate", args_data.get("poison_rate"))

    join_ranks(config.gpu)

    def decide():
        os.makedirs(config.output_dir, exist_ok=True)
        with open(os.path.join(config.output_dir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(config), f, indent=2, default=str)

    run_dir_handshake(config.output_dir, decide)
    return config


def update_score_file(config: ANPConfig, mse_sc, ssim_sc, epoch: Optional[int]) -> dict:
    """MSE/SSIM[_ep{n}][_noclip] and MSE_best (min) / SSIM_best (max)
    (reference anp_util.py:233-270)."""

    def get_key(key):
        res = f"{key}_ep{epoch}" if epoch is not None else key
        res += "_noclip" if not config.clip else ""
        return res

    path = os.path.join(config.output_dir, config.score_file)
    sc = {}
    if os.path.exists(path):
        with open(path) as f:
            sc = json.load(f)
    if mse_sc is not None:
        sc[get_key("MSE")] = mse_sc
        sc["MSE_best"] = min(mse_sc, sc.get("MSE_best", mse_sc))
    if ssim_sc is not None:
        sc[get_key("SSIM")] = ssim_sc
        sc["SSIM_best"] = max(ssim_sc, sc.get("SSIM_best", ssim_sc))
    with open(path, "w") as f:
        json.dump(sc, f, indent=2, sort_keys=True)
    return sc


def measure(config: ANPConfig, pipeline, dsl, tracker, epoch: Optional[int] = None):
    """Generations from clean noise against the backdoor target (reference
    anp_defense.py:77-112)."""
    ep = epoch + 1 if epoch is not None else config.epoch
    step = dsl.num_batch * ep
    path = os.path.join(config.output_dir, config.measure_dir, f"ep{ep}")
    noise = measure_noise(config.seed, pipeline.sample_shape(config.measure_sample_n), pipeline.device)
    imgs = batch_sampling(config.measure_sample_n, pipeline, init=noise, seed=config.seed,
                          num_inference_steps=config.sampling_steps)
    save_images(imgs, path)
    tiled = np.ascontiguousarray(np.broadcast_to(target_images(dsl), imgs.shape))
    mse_sc = float(mse_fn(imgs, tiled, device=pipeline.device))
    ssim_sc = float(ssim_fn(imgs, tiled, device=pipeline.device))
    Log.info(f"[{ep}] MSE: {mse_sc}, SSIM: {ssim_sc}")
    sc = update_score_file(config, mse_sc, ssim_sc, epoch=ep if epoch is not None else None)
    tracker.log(dict(sc), step=step)
    return mse_sc, ssim_sc


def main(argv=None) -> None:
    config = get_config(argv)
    device = resolve_device(device_from_gpu(config.gpu))
    ranks, primary = world_size(), is_primary()
    dsl = DatasetLoader(
        config.dataset, root=config.dataset_path, batch_size=config.batch,
        seed=config.seed, fake_size=config.fake_size,
    )
    # the fully poisoned set (anp_util.py:149)
    dsl.set_poison(config.trigger, config.target, clean_rate=0.0, poison_rate=1.0)
    dsl.prepare_dataset(mode=DatasetLoader.MODE_FIXED)

    # the optimisation computes in bf16 on f32 weights (the reference runs it
    # under an fp16 autocast); the weights stay frozen on the device
    model, scheduler, get_pipeline = factory.get_trained(config.ckpt, clip_sample=config.clip, device=device)
    schedule = scheduler.create_state().schedule
    perturb = init_perturb(dict(model.named_parameters()))
    if config.lr_sched:
        optimizer, lr_schedule = make_optimizer(
            config.learning_rate, num_warmup_steps=config.lr_warmup_steps,
            num_training_steps=dsl.num_batch * config.epoch,
        )
    else:
        optimizer, lr_schedule = make_optimizer(config.learning_rate, schedule="constant", grad_clip=1.0)
    opt_state = optimizer.init(perturb_leaves(perturb))
    # the batch's rows over the data ranks (one rank: the whole batch)
    rows = batch_sharding(make_mesh(device)) if ranks > 1 else None
    step_fn = make_anp_step(model, optimizer, scheduler.config.num_train_timesteps, schedule.alphas,
                            schedule.alphas_cumprod, perturb_budget=config.perturb_budget, device=device, data=rows)

    def make_pipe():
        # the merged weights in a copy of the UNet; the reference samples
        # and measures with its unwrapped f32 model, bf16 is opt-in
        unet = perturbed_copy(model, perturb)
        unet.dtype = torch.float32
        return get_pipeline(scheduler, unet=unet, device=device,
                            compute_dtype=torch.bfloat16 if config.eval_dtype == "bf16" else None)

    tracker = None
    if primary:  # one rank logs
        tracker = Tracker(os.path.join(config.output_dir, "logs"), project=config.project,
                          run_name=os.path.basename(config.output_dir))
    gstep = 0
    last_measure = None
    try:
        barrier("anp_first_step")  # the counterpart of the JAX command line's AlignedStep
        for epoch in range(config.epoch):
            for batch in dsl.epoch_batches(epoch):
                if rows is not None:
                    batch = rows(batch)
                generator = torch.Generator(device).manual_seed(step_seed(config.seed, gstep))
                perturb, opt_state, metrics = step_fn(perturb, opt_state, batch["image_u8"], batch["is_clean"],
                                                      dsl.trigger, dsl.target, dsl.mask, generator)
                if tracker is not None:
                    logs = {k: float(v) for k, v in metrics.items()}
                    logs.update({"epoch": epoch, "step": gstep, "lr": float(lr_schedule(gstep))})
                    tracker.log(logs, step=gstep)
                gstep += 1
            if (epoch + 1) % config.save_image_epochs == 0:
                if primary:
                    pipe = make_pipe()
                    sample_grids(pipe, dsl.trigger, config.output_dir, epoch, sample_n=config.eval_sample_n,
                                 num_inference_steps=config.sampling_steps, seed=config.seed)
                    last_measure = (epoch, measure(config, pipe, dsl, tracker, epoch=epoch))
                barrier("anp_eval", timeout_s=3600.0)

        if primary:
            Log.info("Save model and sample images")
            pipe = make_pipe()
            pipe.save_pretrained(config.output_dir)
            sample_grids(pipe, dsl.trigger, config.output_dir, "final", sample_n=config.eval_sample_n,
                         num_inference_steps=config.sampling_steps, seed=config.seed)
            if last_measure is not None and last_measure[0] == config.epoch - 1:
                # the last epoch's measure sampled this very perturbation with the
                # same seed: record its scores under the bare keys
                mse_sc, ssim_sc = last_measure[1]
                sc = update_score_file(config, mse_sc, ssim_sc, epoch=None)
                tracker.log(dict(sc), step=dsl.num_batch * config.epoch)
            else:
                measure(config, pipe, dsl, tracker, epoch=None)
        # peers leave only once rank 0 has written everything
        barrier("anp_done", timeout_s=3600.0)
    finally:
        if tracker is not None:
            tracker.close()


if __name__ == "__main__":
    main()
