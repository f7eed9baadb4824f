"""A matched VE score model, trained and sampled (port of the JAX package's
``examples/train_sde_ve.py``).

Trains a σ-conditioned score model (``SCORE_MODEL_CONFIG``: Fourier time
embedding of log σ, 128/128/256 channels, attention at 16x16; bf16 compute
on f32 parameters) with VE denoising score matching
(``training.make_ve_train_step``) on the staged dataset, or on FAKE (4096
images) where the dataset cannot be loaded offline; then runs the full
2000-step predictor-corrector SDE-VE chain from the JAX demo's noise (bit
for bit, ``metrics/_prng.py``) with f32 weights and bf16 compute, as the JAX
script's pipeline does, and scores it with the FID proxy against the
training images. σ runs from 0.01 to 50, the NCSN++ CIFAR-10 ladder.

Writes into ``out``: the pipeline in the HF layout, ``ref_images/``,
``pc_samples/``, ``pc_grid.png`` and the row (``result.json``). The JAX
script adds its row to ``SWEEP.json``; this one never writes outside
``out``. The chain runs in segments of ``--sample_segment`` steps (500 by
default, as the JAX script's; 0 for one whole chain): CUDA graphs on the
card (``pipelines/segments.py``).

    python -m baddiffusion_tpu_torch.examples.train_sde_ve [--steps 4000] [--n 256] [--out sde_ve_out]
        [--sample_segment 500] [--gpu cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import numpy as np
import torch

from baddiffusion_tpu_torch.config import device_from_gpu
from baddiffusion_tpu_torch.data import DatasetLoader
from baddiffusion_tpu_torch.device import DeviceLike, resolve_device
from baddiffusion_tpu_torch.examples.attack_demo import initial_noise
from baddiffusion_tpu_torch.metrics.fid import fid as fid_fn
from baddiffusion_tpu_torch.models import UNet2DConfig, UNet2DModel
from baddiffusion_tpu_torch.pipelines import DiffusionPipeline
from baddiffusion_tpu_torch.schedulers import ScoreSdeVeConfig, ScoreSdeVeScheduler
from baddiffusion_tpu_torch.training import create_score_train_state, make_optimizer, make_ve_train_step
from baddiffusion_tpu_torch.utils.image import save_image_grid, save_images

SCORE_MODEL_CONFIG = UNet2DConfig(
    sample_size=32,
    time_embedding_type="fourier",  # NCSN++ conditioning: fourier(log sigma)
    block_out_channels=(128, 128, 256),
    down_block_types=("DownBlock2D", "AttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "AttnUpBlock2D", "UpBlock2D"),
)


def load_data(dataset: str, batch: int, image_size: int, fake_size: int) -> DatasetLoader:
    """The staged dataset, or FAKE (``fake_size`` images) where it cannot be
    loaded offline (no ``datasets`` package, or not in the local cache),
    unpoisoned."""
    try:
        dsl = DatasetLoader(dataset, image_size=image_size, batch_size=batch, fake_size=fake_size)
    except (ImportError, OSError, ValueError, NotImplementedError) as exc:
        print(f"[sde-ve] {dataset} not loadable offline ({type(exc).__name__}); training on FAKE {fake_size}",
              flush=True)
        dsl = DatasetLoader(DatasetLoader.FAKE, image_size=image_size, batch_size=batch, fake_size=fake_size)
    return dsl.set_poison("NONE", "TRIGGER", poison_rate=0.0).prepare_dataset()


def run(steps: int = 4000, batch: int = 128, lr: float = 2e-4, sigma_max: float = 50.0, n: int = 256,
        out: str = "sde_ve_out", dataset: str = "CIFAR10", *, sampling_steps: int = None, fake_size: int = 4096,
        model_config: UNet2DConfig = SCORE_MODEL_CONFIG, log_every: int = 250, sample_segment: int = None,
        device: DeviceLike = None) -> Dict:
    """Train ``steps`` steps, sample ``n`` images with the PC chain
    (``sampling_steps``, default the scheduler's 2000; in segments of
    ``sample_segment`` steps when given), write the outputs
    into ``out`` and return the row (with ``train_s``,
    ``train_steps_per_s`` and ``sample_s``)."""
    dev = resolve_device(device)
    size = model_config.sample_size
    dsl = load_data(dataset, batch, size, fake_size)
    sched = ScoreSdeVeScheduler(ScoreSdeVeConfig(sigma_max=sigma_max))
    model = UNet2DModel(model_config, device=dev, generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    optimizer, _ = make_optimizer(lr, num_warmup_steps=500, num_training_steps=steps)
    state = create_score_train_state(model, optimizer)
    step = make_ve_train_step(model, optimizer, sched.create_state().discrete_sigmas, device=dev)

    print(f"[sde-ve] {n_params / 1e6:.1f}M-param score model, sigma [{sched.config.sigma_min}, {sigma_max}], "
          f"{steps} steps @ batch {batch}", flush=True)
    t0, i, epoch, m = time.perf_counter(), 0, 0, None
    while i < steps:
        for b in dsl.epoch_batches(epoch):
            if i >= steps:
                break
            state, m = step(state, b["image_u8"], torch.Generator(dev).manual_seed(i))
            if i % log_every == 0:
                print(f"[sde-ve] step {i}: loss {float(m['loss']):.4f} ({time.perf_counter() - t0:.0f}s)", flush=True)
            i += 1
        epoch += 1
    final_loss = float(m["loss"]) if m is not None else float("nan")
    train_s = time.perf_counter() - t0
    print(f"[sde-ve] trained {i} steps in {train_s:.0f}s, final loss {final_loss:.4f}", flush=True)

    # f32 weights, bf16 compute: one cast of the weights a chain (compute_copy)
    model.dtype = torch.float32
    pipe = DiffusionPipeline(model, sched, default_inference_steps=sched.config.num_train_timesteps,
                             hf_class_name="ScoreSdeVePipeline", compute_dtype=torch.bfloat16, device=dev)
    pipe.segment_steps = sample_segment
    os.makedirs(out, exist_ok=True)
    pipe.save_pretrained(out)

    # reference images for the FID proxy: the training distribution itself
    ref_dir = os.path.join(out, "ref_images")
    if not os.path.isdir(ref_dir):
        imgs = []
        for b in dsl.epoch_batches(0):
            imgs.append(b["image_u8"])
            if sum(x.shape[0] for x in imgs) >= n:
                break
        save_images(np.concatenate(imgs)[:n].astype(np.float32) / 255.0, ref_dir)

    noise = initial_noise(pipe.sample_shape(n))
    t0 = time.perf_counter()
    imgs = pipe(init=noise, generator=torch.Generator(dev).manual_seed(0), num_inference_steps=sampling_steps).images
    sample_s = time.perf_counter() - t0
    samples_dir = os.path.join(out, "pc_samples")
    save_images(imgs, samples_dir)
    save_image_grid(imgs[:16], os.path.join(out, "pc_grid.png"), 4, 4)
    fid = float(fid_fn([ref_dir, samples_dir], device=dev))
    row = {
        "FID_proxy": round(fid, 2),
        "imgs_per_sec": round(n / sample_s, 3),
        "steps": sampling_steps or sched.config.num_train_timesteps,
        "measure_sample_n": n,
        "note": "matched sigma-conditioned score model trained with VE DSM (training/score_matching.py), "
                "the on-distribution SDE-VE run",
        "score_model_params_m": round(n_params / 1e6, 1),
        "train_steps": steps,
        "final_loss": final_loss,
        "run_dir": out,
    }
    with open(os.path.join(out, "result.json"), "w") as f:
        json.dump(row, f, indent=2, sort_keys=True)
    print(json.dumps(row, indent=2), flush=True)
    return dict(row, train_s=train_s, train_steps_per_s=steps / train_s if train_s > 0 else float("nan"),
                sample_s=sample_s)


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=4000)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--sigma_max", type=float, default=50.0)
    p.add_argument("--n", type=int, default=256, help="samples for the FID_proxy row")
    p.add_argument("--out", default="sde_ve_out")
    p.add_argument("--dataset", default="CIFAR10")
    p.add_argument("--sample_segment", type=int, default=500, help="chain steps a segment (0: one whole chain)")
    p.add_argument("--gpu", type=str, default=None, help="N for cuda:N, 'cpu' for the plain PyTorch path")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    row = run(args.steps, args.batch, args.lr, args.sigma_max, args.n, args.out, args.dataset,
              sample_segment=args.sample_segment or None, device=device_from_gpu(args.gpu))
    print(f"train_sde_ve: {args.steps} steps in {row['train_s']:.1f} s ({row['train_steps_per_s']:.3f} steps/s), "
          f"the chain {row['sample_s']:.1f} s, wall {time.perf_counter() - t0:.1f} s", flush=True)
    return row


if __name__ == "__main__":
    main()
