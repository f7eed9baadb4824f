"""The sampler zoo over one checkpoint (port of the JAX package's
``examples/sampler_sweep.py``).

Drives ``--mode measure --sched <name>`` through the port's command line for
every scheduler name the factory dispatches, against one backdoored run
directory, and records each sampler's scores beside its throughput (one
warm call, then one timed call of ``--time_n`` images at the pipeline's
default length, f32 as the measure samples). Karras-VE, which the command
line does not dispatch (nor does the reference's), gets a sampling-only row
through the library pipeline and a 4x4 grid in ``<ckpt>/karras_ve_samples``.

    {sched: {FID_proxy, MSE, SSIM, imgs_per_sec, steps, measure_wall_s, measure_sample_n}}

The table goes to ``--out`` (``torch_examples_out/SWEEP.json`` by default;
the repo root's ``SWEEP.json`` is the JAX package's); a name already in it
is skipped. The measure dumps the real images into ``measure/<dataset>``
under the working directory, as the command line does.

    python -m baddiffusion_tpu_torch.examples.sampler_sweep --ckpt RUN [--n 256] [--time_n 64]
        [--eval_max_batch N] [--scheds ...] [--out FILE] [--gpu cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from baddiffusion_tpu_torch import cli, factory
from baddiffusion_tpu_torch.config import device_from_gpu
from baddiffusion_tpu_torch.metrics._prng import normal, prng_key
from baddiffusion_tpu_torch.pipelines import DiffusionPipeline
from baddiffusion_tpu_torch.schedulers import KarrasVeConfig, KarrasVeScheduler
from baddiffusion_tpu_torch.utils.image import save_image_grid

SCHEDS = [
    "DDPM-SCHED", "DDIM-SCHED", "PNDM-SCHED", "DEIS-SCHED", "HEUN-SCHED",
    "LMSD-SCHED", "UNIPC-SCHED",
    "DPM_SOLVER_PP_O1-SCHED", "DPM_SOLVER_PP_O2-SCHED", "DPM_SOLVER_PP_O3-SCHED",
    "DPM_SOLVER_O1-SCHED", "DPM_SOLVER_O2-SCHED", "DPM_SOLVER_O3-SCHED",
    "SCORE-SDE-VE-SCHED",
]
KARRAS_ROW = "KARRAS-VE (sampling only)"
DEFAULT_OUT = os.path.join("torch_examples_out", "SWEEP.json")


def timed_sampling(pipe: DiffusionPipeline, n: int, steps: Optional[int] = None, seed: int = 0):
    """imgs/s of one call of ``n`` images after a warm call, from the JAX
    script's noise (``normal(PRNGKey(seed))``); returns (imgs/s, steps, images)."""
    steps = steps or pipe.default_inference_steps
    noise = normal(prng_key(seed), pipe.sample_shape(n))
    pipe(init=noise, generator=torch.Generator(pipe.device).manual_seed(seed), num_inference_steps=steps)
    t0 = time.perf_counter()
    imgs = pipe(init=noise, generator=torch.Generator(pipe.device).manual_seed(seed), num_inference_steps=steps).images
    return n / (time.perf_counter() - t0), steps, imgs


def _save(table: Dict, out: str) -> None:
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(table, f, indent=2, sort_keys=True)


def run(ckpt: str, n: int = 256, time_n: int = 64, eval_max_batch: Optional[int] = None, out: str = DEFAULT_OUT,
        scheds: Sequence[str] = SCHEDS, gpu: Optional[str] = None, *, steps: Optional[int] = None) -> Dict:
    """Measure every name in ``scheds`` and add the Karras-VE row; returns
    the table. ``steps`` overrides every chain's length (the measure's
    ``--measure_steps``; default each pipeline's own)."""
    device = device_from_gpu(gpu)
    table = {}
    if os.path.exists(out):
        with open(out) as f:
            table = json.load(f)
    score_path = os.path.join(ckpt, "score.json")
    for sched in scheds:
        if sched in table:
            print(f"[sweep] {sched}: already recorded, skipping", flush=True)
            continue
        print(f"[sweep] measure --sched {sched}", flush=True)
        argv = ["--mode", "measure", "--ckpt", ckpt, "--sched", sched, "--measure_sample_n", str(n),
                "--eval_max_batch", str(eval_max_batch or n)]
        argv += (["--gpu", gpu] if gpu else []) + (["--measure_steps", str(steps)] if steps else [])
        t0 = time.perf_counter()
        cli.main(argv)
        wall = time.perf_counter() - t0
        with open(score_path) as f:
            sc = json.load(f)
        _, scheduler, get_pipeline = factory.get_trained(ckpt, clip_sample=False, noise_sched_type=sched,
                                                         dtype=torch.float32, device=device)
        ips, n_steps, _ = timed_sampling(get_pipeline(scheduler, device=device), time_n, steps)
        table[sched] = {
            "FID_proxy": sc.get("FID_proxy_noclip", sc.get("FID_proxy")),
            "MSE": sc.get("MSE_noclip", sc.get("MSE")),
            "SSIM": sc.get("SSIM_noclip", sc.get("SSIM")),
            "imgs_per_sec": round(ips, 3),
            "steps": n_steps,
            "measure_wall_s": round(wall, 1),
            "measure_sample_n": n,
        }
        _save(table, out)
        print(f"[sweep] {sched}: {table[sched]}", flush=True)

    if KARRAS_ROW not in table:
        print("[sweep] Karras-VE sampling run", flush=True)
        model, _, _ = factory.get_trained(ckpt, clip_sample=False, dtype=torch.float32, device=device)
        pipe = DiffusionPipeline(model, KarrasVeScheduler(KarrasVeConfig()), default_inference_steps=50,
                                 hf_class_name="KarrasVePipeline", device=device)
        ips, n_steps, imgs = timed_sampling(pipe, time_n, steps)
        save_image_grid(np.asarray(imgs[:16]), os.path.join(ckpt, "karras_ve_samples", "grid.png"), 4, 4)
        table[KARRAS_ROW] = {"imgs_per_sec": round(ips, 3), "steps": n_steps,
                             "note": "not dispatched by the command line (as in the reference); library sampling"}
        _save(table, out)
    dev = torch.device(device)
    table["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    _save(table, out)
    print(json.dumps(table, indent=2, sort_keys=True), flush=True)
    return table


def parser() -> argparse.ArgumentParser:
    """The JAX script's flags and defaults (outputs under git-ignored
    directories), and ``--gpu``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True)
    p.add_argument("--n", type=int, default=256, help="measure sample count per branch")
    p.add_argument("--time_n", type=int, default=64, help="batch for the imgs/s timing")
    p.add_argument("--eval_max_batch", type=int, default=None,
                   help="the measure's chunk (default: --n in one chunk)")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--scheds", nargs="*", default=SCHEDS)
    p.add_argument("--gpu", type=str, default=None, help="N for cuda:N, 'cpu' for the plain PyTorch path")
    return p


def main(argv=None) -> Dict:
    args = parser().parse_args(argv)
    return run(args.ckpt, args.n, args.time_n, args.eval_max_batch, args.out, args.scheds, args.gpu)


if __name__ == "__main__":
    main()
