"""The ANP perturbation budget's dose-response (port of the JAX package's
``examples/anp_dose_response.py``).

The budget is the knob the ANP defense turns: too small and the
perturbation cannot reach the backdoor neurons, too large and clean quality
collapses. This runs the port's ``anp_cli.main()`` on one backdoored run
directory at each budget (the reference recipe otherwise: fully poisoned
loader, per-epoch measure with best-tracking) and records the trade-off:

    {budget: {MSE_best, SSIM_best, MSE_final, SSIM_final, run_dir, wall_s, clean_FID_proxy}}

``MSE_final``/``SSIM_final`` are the last epoch's scores (ANP writes epoch
e's as ``*_ep{e+1}``; the JAX script reads ``*_ep{epoch-1}``, the epoch
before the last). ``clean_FID_proxy`` is the clean side: the final perturbed model's clean
samples against the measure's dump of real images (``measure/<dataset>``
under the working directory, where an earlier measure of the run put it),
added only where that dump exists.

    python -m baddiffusion_tpu_torch.examples.anp_dose_response --ckpt RUN [--budgets 0.5 1 2 4]
        [--epoch 5] [--n 128] [--sampling_steps 1000] [--eval_dtype bf16] [--out FILE] [--gpu cpu]

The table goes to ``--out`` (``torch_examples_out/ANP_SWEEP.json`` by
default; the repo root's ``ANP_SWEEP.json`` is the JAX package's); each ANP
run directory goes beside it, under ``torch_examples_out/``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from baddiffusion_tpu_torch import anp_cli, factory
from baddiffusion_tpu_torch.config import device_from_gpu
from baddiffusion_tpu_torch.metrics.fid import fid as fid_fn
from baddiffusion_tpu_torch.metrics._prng import normal, prng_key
from baddiffusion_tpu_torch.utils.image import save_images

DEFAULT_OUT = os.path.join("torch_examples_out", "ANP_SWEEP.json")


def anp_run(ckpt: str, budget: float, lr: float, epoch: int, n: int, sampling_steps: int, eval_dtype: str,
            runs_dir: str, gpu: Optional[str], anp_flags: Sequence[str] = ()) -> tuple:
    """One ``anp_cli.main()`` run (``anp_flags`` appended to its command
    line); returns (its run dir, its score.json, the wall seconds)."""
    argv = ["--ckpt", ckpt, "--perturb_budget", f"{budget:g}", "--learning_rate", f"{lr:g}", "--epoch", str(epoch),
            "--measure_sample_n", str(n), "--sampling_steps", str(sampling_steps), "--eval_dtype", eval_dtype,
            "--output_dir", runs_dir] + (["--gpu", gpu] if gpu else []) + list(anp_flags)
    t0 = time.perf_counter()
    anp_cli.main(argv)
    wall = time.perf_counter() - t0
    config = dataclasses.replace(anp_cli.ANPConfig(), epoch=epoch, learning_rate=lr, perturb_budget=budget,
                                 ckpt=ckpt)
    run_dir = os.path.join(runs_dir, anp_cli.naming_fn(config))
    with open(os.path.join(run_dir, "score.json")) as f:
        return run_dir, json.load(f), wall


def measure_dump(ckpt: str) -> str:
    """The measure's real-image dump for the run's dataset (cwd-relative)."""
    with open(os.path.join(ckpt, "args.json")) as f:
        dataset = json.load(f)["dataset"] or "CIFAR10"
    return os.path.join("measure", dataset)


def clean_fid(run_dir: str, dataset_dir: str, n: int, sampling_steps: int, eval_dtype: str, device) -> float:
    """The FID proxy of ``n`` clean samples of the run's exported pipeline
    (the JAX script's noise, ``normal(PRNGKey(0))``) against ``dataset_dir``."""
    _, scheduler, get_pipeline = factory.get_trained(run_dir, clip_sample=False, dtype=torch.float32, device=device)
    pipe = get_pipeline(scheduler, device=device)
    pipe.compute_dtype = torch.bfloat16 if eval_dtype == "bf16" else None
    noise = normal(prng_key(0), pipe.sample_shape(n))
    imgs = pipe(init=noise, generator=torch.Generator(pipe.device).manual_seed(0),
                num_inference_steps=sampling_steps).images
    d = os.path.join(run_dir, "clean_fid_samples")
    save_images(np.asarray(imgs), d)
    return float(fid_fn([dataset_dir, d], device=pipe.device))


def _save(table: Dict, out: str) -> None:
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(table, f, indent=2, sort_keys=True)


def run(ckpt: str, budgets: Sequence[float] = (0.5, 1.0, 2.0, 4.0), epoch: int = 5, n: int = 128,
        sampling_steps: int = 1000, eval_dtype: str = "bf16", out: str = DEFAULT_OUT,
        gpu: Optional[str] = None, *, anp_flags: Sequence[str] = ()) -> Dict:
    """Run ANP at every budget; returns the table. ``anp_flags`` go to each
    ``anp_cli`` command line (``--batch``, ``--fake_size``: a small run)."""
    table = {}
    if os.path.exists(out):
        with open(out) as f:
            table = json.load(f)
    runs_dir = os.path.dirname(out) or "."
    for budget in budgets:
        key = f"{budget:g}"
        if key in table:
            print(f"[anp-sweep] budget {key}: already recorded, skipping", flush=True)
            continue
        print(f"[anp-sweep] budget {key}", flush=True)
        run_dir, sc, wall = anp_run(ckpt, budget, 1e-4, epoch, n, sampling_steps, eval_dtype, runs_dir, gpu, anp_flags)
        table[key] = {"MSE_best": sc.get("MSE_best"), "SSIM_best": sc.get("SSIM_best"),
                      "MSE_final": sc.get(f"MSE_ep{epoch}"), "SSIM_final": sc.get(f"SSIM_ep{epoch}"),
                      "run_dir": run_dir, "wall_s": round(wall, 1)}
        _save(table, out)
        print(f"[anp-sweep] budget {key}: {table[key]}", flush=True)

    dataset_dir = measure_dump(ckpt)
    device = device_from_gpu(gpu)
    for key, row in sorted(table.items(), key=lambda kv: float(kv[0])):
        if "clean_FID_proxy" in row or not os.path.isdir(dataset_dir):
            continue
        row["clean_FID_proxy"] = clean_fid(row["run_dir"], dataset_dir, n, sampling_steps, eval_dtype, device)
        _save(table, out)
        print(f"[anp-sweep] budget {key}: clean_FID_proxy={row['clean_FID_proxy']:.2f}", flush=True)
    print(json.dumps(table, indent=2, sort_keys=True), flush=True)
    return table


def parser() -> argparse.ArgumentParser:
    """The JAX script's flags and defaults (outputs under git-ignored
    directories), and ``--gpu``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True)
    p.add_argument("--budgets", nargs="*", type=float, default=[0.5, 1.0, 2.0, 4.0])
    p.add_argument("--epoch", type=int, default=5)
    p.add_argument("--n", type=int, default=128, help="measure_sample_n per epoch")
    p.add_argument("--sampling_steps", type=int, default=1000)
    p.add_argument("--eval_dtype", default="bf16")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--gpu", type=str, default=None, help="N for cuda:N, 'cpu' for the plain PyTorch path")
    return p


def main(argv=None) -> Dict:
    args = parser().parse_args(argv)
    return run(args.ckpt, args.budgets, args.epoch, args.n, args.sampling_steps, args.eval_dtype, args.out,
               args.gpu)


if __name__ == "__main__":
    main()
