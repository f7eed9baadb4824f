"""The backdoor attack end to end (port of the JAX package's
``examples/attack_demo.py``).

Trains the demo UNet (64/128/256 channels, attention at 16x16 in heads of 8,
bf16 compute on f32 parameters) from scratch on the synthetic FAKE set (2048
images) with 30% BOX_14 -> CORNER poisoning at batch 128 (Adam 2e-4, 200
warmup steps, cosine), then samples 64 images from noise and 64 from noise +
trigger with 1000 DDPM steps and scores MSE/SSIM against the backdoor
target. The initial noise is the JAX demo's, bit for bit
(``jax.random.normal(PRNGKey(0), (64, 32, 32, 3))`` through the port's
threefry, ``metrics/_prng.py``); the training draws are the port's own.

The paper's acceptance shape: triggered generation collapses to the target
(backdoor MSE about 1e-4, SSIM near 1) while clean generation stays off it.

Writes into ``out``: ``backdoor_grid.png`` and ``clean_grid.png`` (4x4),
``result.json``, the pipeline in the HF layout and the ``args.json`` that
``defense_demo`` (and ``anp_cli``) read.

    python -m baddiffusion_tpu_torch.examples.attack_demo [--steps 3000] [--out attack_demo_out] [--gpu cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from baddiffusion_tpu_torch.config import device_from_gpu
from baddiffusion_tpu_torch.data import DatasetLoader
from baddiffusion_tpu_torch.device import DeviceLike, resolve_device
from baddiffusion_tpu_torch.metrics import mse, ssim
from baddiffusion_tpu_torch.metrics._prng import normal, prng_key
from baddiffusion_tpu_torch.models import UNet2DConfig, UNet2DModel
from baddiffusion_tpu_torch.pipelines import DiffusionPipeline
from baddiffusion_tpu_torch.schedulers import DDPMConfig, DDPMScheduler
from baddiffusion_tpu_torch.training import create_train_state, make_optimizer, make_train_step
from baddiffusion_tpu_torch.training.trainer import step_seed
from baddiffusion_tpu_torch.utils.image import save_image_grid

ATTACK_MODEL_CONFIG = UNet2DConfig(
    sample_size=32, layers_per_block=2, block_out_channels=(64, 128, 256),
    down_block_types=("DownBlock2D", "AttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "AttnUpBlock2D", "UpBlock2D"),
    norm_num_groups=32, attention_head_dim=8,
)
TRIGGER, TARGET, POISON_RATE, LR = "BOX_14", "CORNER", 0.3, 2e-4


def initial_noise(shape) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(0), shape)``, bit for bit."""
    return normal(prng_key(0), shape)


def target_scores(images: np.ndarray, clean: Optional[np.ndarray], target: np.ndarray,
                  device: torch.device) -> Dict[str, float]:
    """MSE/SSIM of the backdoor (and clean) images to the target in [0, 1]."""
    target01 = np.clip(target / 2 + 0.5, 0, 1)
    tiled = np.ascontiguousarray(np.broadcast_to(target01, images.shape)).astype(np.float32)
    res = {"backdoor_mse": float(mse(images, tiled, device=device)),
           "backdoor_ssim": float(ssim(images, tiled, device=device))}
    if clean is not None:
        res["clean_mse_to_target"] = float(mse(clean, tiled, device=device))
        res["clean_ssim_to_target"] = float(ssim(clean, tiled, device=device))
    return res


def run(steps: int = 3000, out: str = "attack_demo_out", *, batch: int = 128, fake_size: int = 2048,
        n: int = 64, sampling_steps: int = 1000, model_config: UNet2DConfig = ATTACK_MODEL_CONFIG,
        log_every: int = 500, device: DeviceLike = None) -> Dict[str, float]:
    """Train ``steps`` steps, sample ``n`` clean and ``n`` backdoor images
    with ``sampling_steps`` DDPM steps, write the outputs into ``out`` and
    return the scores (with ``train_s``, ``train_steps_per_s`` and
    ``sample_s``, the wall times)."""
    dev = resolve_device(device)
    model = UNet2DModel(model_config, device=dev, generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    sched = DDPMScheduler(DDPMConfig())
    schedule = sched.create_state().schedule
    opt, _ = make_optimizer(LR, num_warmup_steps=200, num_training_steps=steps)
    dsl = DatasetLoader(DatasetLoader.FAKE, image_size=model_config.sample_size, batch_size=batch,
                        fake_size=fake_size)
    dsl.set_poison(TRIGGER, TARGET, poison_rate=POISON_RATE).prepare_dataset()
    state = create_train_state(model, opt, dsl.trigger, dsl.target, dsl.mask)
    step = make_train_step(model, opt, 1000, schedule.alphas, schedule.alphas_cumprod, device=dev)

    t0, gstep, epoch = time.perf_counter(), 0, 0
    while gstep < steps:
        for b in dsl.epoch_batches(epoch):
            state, m = step(state, b["image_u8"], b["is_clean"], torch.Generator(dev).manual_seed(step_seed(0, gstep)))
            gstep += 1
            if gstep % log_every == 0:
                print(f"step {gstep}: loss={float(m['loss']):.4f} ({time.perf_counter() - t0:.0f}s)", flush=True)
            if gstep >= steps:
                break
        epoch += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0

    pipe = DiffusionPipeline(model, sched, default_inference_steps=1000, device=dev)
    size, ch = model_config.sample_size, model_config.in_channels
    noise = initial_noise((n, size, size, ch))
    t0 = time.perf_counter()
    clean = pipe(init=noise, generator=torch.Generator(dev).manual_seed(0), num_inference_steps=sampling_steps).images
    bd = pipe(init=noise + dsl.trigger[None], generator=torch.Generator(dev).manual_seed(0),
              num_inference_steps=sampling_steps).images
    sample_s = time.perf_counter() - t0

    res = target_scores(bd, clean, dsl.target, dev)
    print(json.dumps(res, indent=2), flush=True)
    os.makedirs(out, exist_ok=True)
    save_image_grid(bd[:16], os.path.join(out, "backdoor_grid.png"), 4, 4)
    save_image_grid(clean[:16], os.path.join(out, "clean_grid.png"), 4, 4)
    with open(os.path.join(out, "result.json"), "w") as f:
        json.dump(res, f)
    # the backdoored pipeline and the args.json the ANP defense reads
    pipe.save_pretrained(out)
    with open(os.path.join(out, "args.json"), "w") as f:
        json.dump({"trigger": TRIGGER, "target": TARGET, "poison_rate": POISON_RATE, "dataset": "FAKE",
                   "learning_rate": LR}, f)
    return dict(res, train_s=train_s, train_steps_per_s=steps / train_s, sample_s=sample_s)


def main(argv=None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--out", type=str, default="attack_demo_out")
    parser.add_argument("--gpu", type=str, default=None, help="N for cuda:N, 'cpu' for the plain PyTorch path")
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    res = run(args.steps, args.out, device=device_from_gpu(args.gpu))
    print(f"attack_demo: {args.steps} train steps in {res['train_s']:.1f} s ({res['train_steps_per_s']:.3f} steps/s), "
          f"sampling {res['sample_s']:.1f} s, wall {time.perf_counter() - t0:.1f} s", flush=True)
    return res


if __name__ == "__main__":
    main()
