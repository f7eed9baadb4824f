"""Where the 32 px hot paths' device time goes, kernel by kernel (port of the
JAX package's ``examples/profile_attribution.py``).

Runs bench.py's 32 px backdoor train step (the full-width scratch UNet, bf16
compute on f32 parameters, batch 128, BOX_14 -> CORNER at 0.1), or the
1000-step bf16 DDPM chain at batch 128, under torch.profiler
(``utils/profiling.measure_device_time``) and prints the kernels ranked by
device time (``top_device_ops``), each with its class (K1, K2, K3, conv,
matmul, other). The JAX script's byte and FLOP columns have no counterpart:
torch.profiler records neither, so no byte or FLOP column is printed
(``mfu_analysis`` counts the FLOPs).

    python -m baddiffusion_tpu_torch.examples.profile_attribution [train|sample] [--gpu cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Dict, Optional

import torch

from baddiffusion_tpu_torch.config import device_from_gpu
from baddiffusion_tpu_torch.data import DatasetLoader
from baddiffusion_tpu_torch.device import DeviceLike, resolve_device
from baddiffusion_tpu_torch.metrics._prng import normal, prng_key
from baddiffusion_tpu_torch.models import DEFAULT_SCRATCH_CONFIG, UNet2DConfig, UNet2DModel
from baddiffusion_tpu_torch.pipelines import DiffusionPipeline
from baddiffusion_tpu_torch.schedulers import DDPMConfig, DDPMScheduler
from baddiffusion_tpu_torch.training import create_train_state, make_optimizer, make_train_step
from baddiffusion_tpu_torch.utils.profiling import measure_device_time, top_device_ops

BATCH = 128


def scratch_config(image_size: int = 32, model_config: Optional[UNet2DConfig] = None) -> UNet2DConfig:
    return dataclasses.replace(model_config or DEFAULT_SCRATCH_CONFIG, sample_size=image_size)


def bench_train_step(dev: torch.device, image_size: int = 32, batch: int = BATCH, grad_accum: int = 1,
                     remat: bool = False, model_config: Optional[UNet2DConfig] = None, lr: float = 2e-4):
    """bench.py's backdoor train step on the scratch UNet (seeded, bf16
    compute on f32 parameters), a FAKE global batch of ``batch`` x
    ``grad_accum`` poisoned BOX_14 -> CORNER at 0.1, and Adam (lr, 500 warm-up
    of 10,000 steps). Returns ``(run_once, model, holder)``: ``run_once()``
    takes one step and waits for its loss; ``holder["state"]`` is the state."""
    cfg = scratch_config(image_size, model_config)
    model = UNet2DModel(cfg, device=dev, generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    schedule = DDPMScheduler(DDPMConfig()).create_state().schedule
    optimizer, _ = make_optimizer(lr, num_warmup_steps=500, num_training_steps=10_000)
    global_batch = batch * grad_accum
    dsl = DatasetLoader(DatasetLoader.FAKE, image_size=image_size, batch_size=global_batch, fake_size=global_batch * 2)
    dsl.set_poison("BOX_14", "CORNER", poison_rate=0.1).prepare_dataset()
    holder = {"state": create_train_state(model, optimizer, dsl.trigger, dsl.target, dsl.mask)}
    step = make_train_step(model, optimizer, 1000, schedule.alphas, schedule.alphas_cumprod, grad_accum=grad_accum,
                           use_remat=remat, device=dev)
    b = next(dsl.epoch_batches(0))
    image, is_clean = torch.from_numpy(b["image_u8"]).to(dev), torch.from_numpy(b["is_clean"]).to(dev)
    gen = torch.Generator(dev).manual_seed(7)

    def run_once():
        holder["state"], m = step(holder["state"], image, is_clean, gen)
        return float(m["loss"])

    return run_once, model, holder


def bench_sampler(dev: torch.device, batch: int = BATCH, steps: int = 1000,
                  model_config: Optional[UNet2DConfig] = None) -> Callable[[], object]:
    """bench.py's sampling chain: the scratch UNet's f32 weights computing in
    bf16, DDPM, ``steps`` steps at ``batch`` from the JAX script's noise."""
    cfg = scratch_config(32, model_config)
    model = UNet2DModel(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    pipe = DiffusionPipeline(model, DDPMScheduler(DDPMConfig()), compute_dtype=torch.bfloat16, device=dev)
    init = normal(prng_key(7), (batch, cfg.sample_size, cfg.sample_size, cfg.in_channels))

    def run_once():
        return pipe(init=init, num_inference_steps=steps, generator=torch.Generator(dev).manual_seed(9)).images

    return run_once


def run(which: str = "train", *, device: DeviceLike = None, batch: int = BATCH, sampling_steps: int = 1000,
        model_config: Optional[UNet2DConfig] = None, top: int = 40) -> Dict:
    """Profile the path (4 train steps, or one chain, after one warm-up
    call) and print its kernels by device time; returns the
    ``measure_device_time`` stats with ``rows`` (class, kernel, ms a step)."""
    dev = resolve_device(device)
    if which == "train":
        run_once, steps = bench_train_step(dev, batch=batch, model_config=model_config)[0], 4
    elif which == "sample":
        run_once, steps = bench_sampler(dev, batch, sampling_steps, model_config), 1
    else:
        raise ValueError(f"which must be 'train' or 'sample', got {which!r}")
    stats = measure_device_time(run_once, steps=steps, device=dev)
    rows = top_device_ops(stats, k=4096)
    total = sum(ms for _, _, ms in rows) or 1.0
    print(f"== {which} on {stats['device']}: {stats['device_time_ms_per_step']:.2f} ms device a step, "
          f"{stats['wall_ms_per_step']:.2f} ms wall, idle {100 * stats['idle_share']:.1f}% (no byte or FLOP column: "
          "torch.profiler records neither) ==")
    print(f"{'time%':>6} {'t_ms':>9}  {'class':<6} kernel")
    shown = 0.0
    for cls, name, ms in rows[:top]:
        shown += 100 * ms / total
        print(f"{100 * ms / total:6.2f} {ms:9.4f}  {cls:<6} {name[:110]}")
    print(f"(top {min(top, len(rows))} = {shown:.1f}% of device time; {len(rows)} kernels in all)", flush=True)
    return dict(stats, rows=rows)


def parser() -> argparse.ArgumentParser:
    """The JAX script's argument (``train`` or ``sample``), and ``--gpu``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("which", nargs="?", default="train", choices=["train", "sample"])
    p.add_argument("--gpu", type=str, default=None, help="N for cuda:N, 'cpu' for the plain PyTorch path")
    return p


def main(argv=None) -> Dict:
    args = parser().parse_args(argv)
    return run(args.which, device=device_from_gpu(args.gpu))


if __name__ == "__main__":
    main()
