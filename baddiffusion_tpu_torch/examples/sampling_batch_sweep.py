"""The sampling batch sweep (port of the JAX package's
``examples/sampling_batch_sweep.py``).

The measure samples 2 x ``measure_sample_n`` images through the 1000-step
DDPM chain in chunks of ``eval_max_batch``. This sweeps the chunk's batch,
and the chain's segment length (``--segments``: 0 for the whole chain as
eager steps, k for segments of k steps, each a CUDA graph on the card), on
bench.py's sampling configuration: the full-width scratch UNet at 32 px with
seeded weights, f32 parameters computing in bf16. Each point: one call that
captures (and warms), then the best of two timed calls, imgs/s. The initial
noise is the JAX script's (``normal(PRNGKey(7))``, bit for bit).

    python -m baddiffusion_tpu_torch.examples.sampling_batch_sweep [--batches 64 128 256 512]
        [--segments 0] [--steps 1000] [--out FILE] [--gpu cpu]

Prints one JSON line a point, then the winner and every row (and the card).
Writes a file only with ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, Optional, Sequence

import torch

from baddiffusion_tpu_torch.config import device_from_gpu
from baddiffusion_tpu_torch.device import DeviceLike, resolve_device
from baddiffusion_tpu_torch.metrics._prng import normal, prng_key
from baddiffusion_tpu_torch.models import DEFAULT_SCRATCH_CONFIG, UNet2DConfig, UNet2DModel
from baddiffusion_tpu_torch.pipelines import DiffusionPipeline
from baddiffusion_tpu_torch.schedulers import DDPMConfig, DDPMScheduler


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run(batches: Sequence[int] = (64, 128, 256, 512), segments: Sequence[int] = (0,), steps: int = 1000,
        out: str = "", *, model_config: Optional[UNet2DConfig] = None, device: DeviceLike = None) -> Dict:
    """Sample every (segment, batch) point; returns ``{"winner", "rows",
    "device"}`` (and writes it to ``out`` when given). A point that fails
    (out of memory) records its error and the sweep goes on."""
    dev = resolve_device(device)
    cfg = model_config or dataclasses.replace(DEFAULT_SCRATCH_CONFIG, sample_size=32)
    model = UNet2DModel(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    pipe = DiffusionPipeline(model, DDPMScheduler(DDPMConfig()), compute_dtype=torch.bfloat16, device=dev)
    size, ch = cfg.sample_size, cfg.in_channels
    rows = []
    for seg in segments:
        pipe.segment_steps = seg or None
        for b in batches:
            init = normal(prng_key(7), (b, size, size, ch))
            try:
                pipe(init=init, num_inference_steps=steps, generator=torch.Generator(dev).manual_seed(8))
                best = float("inf")
                for i in range(2):
                    t0 = time.perf_counter()
                    pipe(init=init, num_inference_steps=steps, generator=torch.Generator(dev).manual_seed(9 + i))
                    best = min(best, time.perf_counter() - t0)  # the images are on the host: the chain is done
                row = {"batch": b, "segment": seg or None, "steps": steps, "imgs_per_sec": round(b / best, 2),
                       "wall_s": round(best, 2)}
            except torch.cuda.OutOfMemoryError as exc:
                row = {"batch": b, "segment": seg or None, "error": f"{type(exc).__name__}: {exc}"[:200]}
            rows.append(row)
            print(json.dumps(row), flush=True)
    ok = [r for r in rows if "imgs_per_sec" in r]
    result = {"winner": max(ok, key=lambda r: r["imgs_per_sec"]) if ok else None, "rows": rows,
              "device": device_name(dev)}
    print(json.dumps(result), flush=True)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(result, f, indent=2)
    return result


def parser() -> argparse.ArgumentParser:
    """The JAX script's flags and defaults (outputs under git-ignored
    directories), and ``--gpu``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batches", nargs="*", type=int, default=[64, 128, 256, 512])
    p.add_argument("--segments", nargs="*", type=int, default=[0], help="0 = the whole chain; k = segments of k")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--out", default="")
    p.add_argument("--gpu", type=str, default=None, help="N for cuda:N, 'cpu' for the plain PyTorch path")
    return p


def main(argv=None) -> Dict:
    args = parser().parse_args(argv)
    return run(args.batches, args.segments, args.steps, args.out, device=device_from_gpu(args.gpu))


if __name__ == "__main__":
    main()
