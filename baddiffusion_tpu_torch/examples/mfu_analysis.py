"""Model FLOPs utilization of the headline train step and sampling chain
(port of the JAX package's ``examples/mfu_analysis.py``).

The JAX script reads XLA's cost model. Here the FLOPs are counted on the
exact calls: ``torch.utils.flop_counter.FlopCounterMode`` over one train
step (forward, backward and optimizer) of bench.py's step, and over one UNet
forward of the sampling chain (times the chain's steps). FlopCounterMode
sees PyTorch's operators (the convolutions and products that carry the
work); the attention kernel (K3) is a hand-written CUDA kernel it cannot
see, so its forward FLOPs are added from its shapes, 4·B·H·T²·D a call (its
backward is plain PyTorch, which the counter sees). The bound is the FLOPs
over the H100's dense bf16 peak, 989 TFLOP/s (NVIDIA's data sheet, SXM, at
its 700 W limit); the card's name and power limit are printed beside it.
There is no byte column: torch.profiler measures no bytes
(``utils/profiling``: ``hbm_*`` is None).

    python -m baddiffusion_tpu_torch.examples.mfu_analysis [--measure] [--image_size 32] [--batch 128]
        [--grad_accum 1] [--remat] [--sampling] [--sampling_steps 1000] [--eval_dtype bf16|fp32] [--gpu cpu]

``--measure`` also times the step (or the chain) and prints MFU; on the CPU
only the counts are printed (a CPU time is no measure of the card).
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import time
from typing import Callable, Dict, Iterator, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from baddiffusion_tpu_torch.config import device_from_gpu
from baddiffusion_tpu_torch.device import DeviceLike, resolve_device
from baddiffusion_tpu_torch.examples.profile_attribution import bench_train_step, scratch_config
from baddiffusion_tpu_torch.models import UNet2DConfig, UNet2DModel
from baddiffusion_tpu_torch.models import attention as attention_module

H100_BF16_PEAK_FLOPS = 989e12  # dense, SXM, NVIDIA's data sheet


@contextlib.contextmanager
def _count_k3(counter: Dict[str, float]) -> Iterator[None]:
    """Add 4·B·H·T²·D for every attention call on the card (the kernel
    FlopCounterMode cannot see); on the CPU the plain version's products
    are counted by FlopCounterMode itself."""
    kernel = attention_module.attention

    def counted(q, k, v, scale):
        if q.is_cuda:
            b, h, t, d = q.shape
            counter["k3"] += 4.0 * b * h * t * t * d
        return kernel(q, k, v, scale)

    attention_module.attention = counted
    try:
        yield
    finally:
        attention_module.attention = kernel


def count_flops(fn: Callable[[], object]) -> float:
    """FLOPs of one call of ``fn``: FlopCounterMode's, plus K3's forward."""
    extra = {"k3": 0.0}
    with _count_k3(extra), FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops()) + extra["k3"]


def card(dev: torch.device) -> str:
    """The card's name and power limit (``nvidia-smi``), or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else torch.cuda.get_device_name(dev)


def _report(label: str, flops: float, batch: int, seconds: Optional[float], dev: torch.device, unit: str) -> Dict:
    bound_s = flops / H100_BF16_PEAK_FLOPS
    print(f"{label}: {flops / 1e9:.1f} GFLOP; at {H100_BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s (H100 dense bf16) "
          f"{bound_s * 1e3:.3f} ms, {batch / bound_s:.0f} {unit}/s at most")
    row = {"flops": flops, "bound_ms": bound_s * 1e3, "device": card(dev), "peak_flops": H100_BF16_PEAK_FLOPS}
    if seconds is not None and dev.type == "cuda":
        row.update(ms=seconds * 1e3, mfu=flops / seconds / H100_BF16_PEAK_FLOPS)
        print(f"  measured on {row['device']}: {seconds * 1e3:.2f} ms = {batch / seconds:.1f} {unit}/s -> MFU "
              f"{100 * row['mfu']:.2f}% of {H100_BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s", flush=True)
    return row


def train_main(measure: bool, image_size: int = 32, batch: int = 128, grad_accum: int = 1, remat: bool = False,
               *, device: DeviceLike = None, model_config: Optional[UNet2DConfig] = None, iters: int = 0) -> Dict:
    dev = resolve_device(device)
    run_once, _, _ = bench_train_step(dev, image_size, batch, grad_accum, remat, model_config)
    run_once()  # the first step builds the kernels and picks the conv algorithms
    flops = count_flops(run_once)
    seconds = None
    if measure:
        n = iters or (30 if image_size <= 64 else 10)
        for _ in range(3):
            run_once()
        t0 = time.perf_counter()
        for _ in range(n):
            run_once()
        seconds = (time.perf_counter() - t0) / n
    label = (f"train step ({image_size} px, micro-batch {batch} x accum {grad_accum}{', remat' if remat else ''})")
    return _report(label, flops, batch * grad_accum, seconds, dev, "samples")


def sampling_main(measure: bool, batch: int = 128, steps: int = 1000, eval_dtype: str = "bf16", *,
                  device: DeviceLike = None, model_config: Optional[UNet2DConfig] = None) -> Dict:
    """The FLOPs of the DDPM chain: one forward of the sampling copy of the
    UNet at ``batch``, times ``steps`` (the scheduler's update is a few
    elementwise passes)."""
    from baddiffusion_tpu_torch.examples.profile_attribution import bench_sampler

    dev = resolve_device(device)
    cfg = scratch_config(32, model_config)
    dtype = torch.bfloat16 if eval_dtype == "bf16" else torch.float32
    unet = UNet2DModel(cfg, device=dev, generator=torch.Generator().manual_seed(0)).compute_copy(dtype)
    x = torch.zeros((batch, cfg.sample_size, cfg.sample_size, cfg.in_channels), device=dev)
    t = torch.full((batch,), 500, device=dev)
    with torch.inference_mode():
        unet(x, t)
        flops = count_flops(lambda: unet(x, t)) * steps
    seconds = None
    if measure:
        chain = bench_sampler(dev, batch, steps, model_config)
        chain()
        t0 = time.perf_counter()
        chain()
        seconds = time.perf_counter() - t0
    return _report(f"sampling ({steps} steps, batch {batch}, {eval_dtype})", flops, batch, seconds, dev, "imgs")


def parser() -> argparse.ArgumentParser:
    """The JAX script's flags and defaults (outputs under git-ignored
    directories), and ``--gpu``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--measure", action="store_true")
    p.add_argument("--image_size", type=int, default=32)
    p.add_argument("--batch", type=int, default=128, help="micro-batch (per accumulation step)")
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--sampling", action="store_true", help="the 1000-step sampling chain instead")
    p.add_argument("--sampling_steps", type=int, default=1000)
    p.add_argument("--eval_dtype", choices=["bf16", "fp32"], default="bf16")
    p.add_argument("--gpu", type=str, default=None, help="N for cuda:N, 'cpu' for the plain PyTorch path")
    return p


def main(argv=None) -> Dict:
    a = parser().parse_args(argv)
    device = device_from_gpu(a.gpu)
    if a.sampling:
        return sampling_main(a.measure, a.batch, a.sampling_steps, a.eval_dtype, device=device)
    return train_main(a.measure, a.image_size, a.batch, a.grad_accum, a.remat, device=device)


if __name__ == "__main__":
    main()
