"""The 256 px step's gradient-accumulation structures, timed (port of the JAX
package's ``examples/accum_variants.py``).

bench.py's 256 px recipe is a global batch of 64 as 16 micro-batches of 4.
The JAX script times four ways XLA can carry that accumulation. The port has
two ways to compute the same step:

  loop        the shipping structure (``training/train.py``): a Python loop
              over micro-batches, each with its own backward, gradients
              summed in the parameters' ``.grad``
  loop@K      the same with K micro-batches of 64/K
  remat_full  one full-batch backward, the UNet forward recomputed during it
              (``torch.utils.checkpoint``): no accumulation, bigger
              convolutions, about a third more FLOPs

``scan`` and ``scan_u4`` (``lax.scan`` over micro-batches, unrolled by 1 or
4) and ``unrolled`` (a traced Python loop inside one XLA program) are ways
to carry the accumulator through an XLA program; an eager step has no such
carry to choose, so they have no counterpart here and give an error row.

    python -m baddiffusion_tpu_torch.examples.accum_variants [--variants loop remat_full] [--iters 5]
        [--hbm] [--gpu cpu]

Prints one JSON line a variant: {variant, step_ms, samples_per_sec,
compile_s (the first step: kernel builds and cuDNN's choices), device}.
``--hbm`` adds the profiled device time and idle share a step
(``utils/profiling``; no byte count is measured).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional, Sequence

import torch

from baddiffusion_tpu_torch.config import device_from_gpu
from baddiffusion_tpu_torch.device import DeviceLike, resolve_device
from baddiffusion_tpu_torch.examples.profile_attribution import bench_train_step
from baddiffusion_tpu_torch.models import UNet2DConfig
from baddiffusion_tpu_torch.utils.profiling import measure_device_time

GLOBAL = 64
ACCUM = 16
XLA_ONLY = ("scan", "scan_u4", "unrolled")


def _structure(variant: str) -> tuple:
    """(grad_accum, remat) of a variant."""
    if variant == "loop":
        return ACCUM, False
    if variant.startswith("loop@"):
        accum = int(variant.split("@")[1])
        if GLOBAL % accum:
            raise ValueError(f"{variant}: {accum} micro-batches do not divide the global batch {GLOBAL}")
        return accum, False
    if variant == "remat_full":
        return 1, True
    raise ValueError(f"unknown variant {variant!r}")


def run(variants: Sequence[str] = ("loop", "remat_full"), iters: int = 5, hbm: bool = False, *,
        image_size: int = 256, device: DeviceLike = None, model_config: Optional[UNet2DConfig] = None) -> List[Dict]:
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rows = []
    for variant in variants:
        if variant in XLA_ONLY:
            out = {"variant": variant, "error": "an XLA carry structure: no eager counterpart"}
            print(json.dumps(out), flush=True)
            rows.append(out)
            continue
        accum, remat = _structure(variant)
        run_once, _, _ = bench_train_step(dev, image_size, GLOBAL // accum, accum, remat, model_config, lr=2e-5)
        try:
            t0 = time.perf_counter()
            run_once()
            compile_s = time.perf_counter() - t0
            for _ in range(2):
                run_once()
            best = float("inf")
            for _ in range(2):
                t0 = time.perf_counter()
                for _ in range(iters):
                    run_once()
                best = min(best, (time.perf_counter() - t0) / iters)
            out = {"variant": variant, "step_ms": round(best * 1e3, 1), "samples_per_sec": round(GLOBAL / best, 2),
                   "compile_s": round(compile_s, 1), "device": name}
            if hbm:
                stats = measure_device_time(run_once, steps=2, device=dev)
                out.update(device_ms_per_step=round(stats["device_time_ms_per_step"], 1),
                           idle_share=round(stats["idle_share"], 4))
        except torch.cuda.OutOfMemoryError as exc:
            out = {"variant": variant, "error": f"{type(exc).__name__}: {exc}"[:200]}
        print(json.dumps(out), flush=True)
        rows.append(out)
    return rows


def parser() -> argparse.ArgumentParser:
    """The JAX script's flags and defaults (outputs under git-ignored
    directories), and ``--gpu``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variants", nargs="*", default=["loop", "remat_full"])
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--hbm", action="store_true", help="also profile the device time and idle share a step")
    p.add_argument("--gpu", type=str, default=None, help="N for cuda:N, 'cpu' for the plain PyTorch path")
    return p


def main(argv=None) -> List[Dict]:
    args = parser().parse_args(argv)
    return run(args.variants, args.iters, args.hbm, device=device_from_gpu(args.gpu))


if __name__ == "__main__":
    main()
