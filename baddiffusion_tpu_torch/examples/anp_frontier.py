"""The ANP defense's frontier over learning rate x epochs at binding budgets
(port of the JAX package's ``examples/anp_frontier.py``).

The budget-only sweep (``anp_dose_response``) holds the reference recipe's
lr 1e-4 and 5 epochs. This sweeps the recipe's other two knobs at budgets
where the clamp binds, each point a full ``anp_cli.main()`` run plus the
clean side, the FID proxy of the final perturbed model's clean samples
against the measure's real-image dump (where it exists):

    {"pb{b}_lr{lr}_ep{E}": {MSE_best, SSIM_best, MSE_final, SSIM_final, clean_FID_proxy, run_dir, wall_s}}

``MSE_final``/``SSIM_final`` are the last epoch's (``*_ep{E}``).

    python -m baddiffusion_tpu_torch.examples.anp_frontier --ckpt RUN [--budgets 0.5 1]
        [--lrs 2e-5 1e-4 5e-4] [--epochs 5] [--n 128] [--sampling_steps 1000] [--eval_dtype bf16]
        [--out FILE] [--gpu cpu]

The table goes to ``--out`` (``torch_examples_out/ANP_FRONTIER.json`` by
default; the repo root's ``ANP_FRONTIER.json`` is the JAX package's); the
ANP run directories beside it.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
from typing import Dict, Optional, Sequence

from baddiffusion_tpu_torch.config import device_from_gpu
from baddiffusion_tpu_torch.examples.anp_dose_response import _save, anp_run, clean_fid, measure_dump

DEFAULT_OUT = os.path.join("torch_examples_out", "ANP_FRONTIER.json")


def run(ckpt: str, budgets: Sequence[float] = (0.5, 1.0), lrs: Sequence[float] = (2e-5, 1e-4, 5e-4),
        epochs: Sequence[int] = (5,), n: int = 128, sampling_steps: int = 1000, eval_dtype: str = "bf16",
        out: str = DEFAULT_OUT, gpu: Optional[str] = None, *, anp_flags: Sequence[str] = ()) -> Dict:
    """Run ANP at every (budget, lr, epochs) point; returns the table.
    ``anp_flags`` go to each ``anp_cli`` command line."""
    table = {}
    if os.path.exists(out):
        with open(out) as f:
            table = json.load(f)
    dataset_dir = measure_dump(ckpt)
    device = device_from_gpu(gpu)
    for budget, lr, ep in itertools.product(budgets, lrs, epochs):
        key = f"pb{budget:g}_lr{lr:g}_ep{ep}"
        if key in table:
            print(f"[frontier] {key}: already recorded, skipping", flush=True)
            continue
        print(f"[frontier] {key}", flush=True)
        run_dir, sc, wall = anp_run(ckpt, budget, lr, ep, n, sampling_steps, eval_dtype, os.path.dirname(out) or ".",
                                    gpu, anp_flags)
        row = {"MSE_best": sc.get("MSE_best"), "SSIM_best": sc.get("SSIM_best"),
               "MSE_final": sc.get(f"MSE_ep{ep}"), "SSIM_final": sc.get(f"SSIM_ep{ep}"),
               "run_dir": run_dir, "wall_s": round(wall, 1)}
        if os.path.isdir(dataset_dir):
            row["clean_FID_proxy"] = round(clean_fid(run_dir, dataset_dir, n, sampling_steps, eval_dtype, device), 2)
        table[key] = row
        _save(table, out)
        print(f"[frontier] {key}: {row}", flush=True)
    print(json.dumps(table, indent=2, sort_keys=True), flush=True)
    return table


def parser() -> argparse.ArgumentParser:
    """The JAX script's flags and defaults (outputs under git-ignored
    directories), and ``--gpu``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True)
    p.add_argument("--budgets", nargs="*", type=float, default=[0.5, 1.0])
    p.add_argument("--lrs", nargs="*", type=float, default=[2e-5, 1e-4, 5e-4])
    p.add_argument("--epochs", nargs="*", type=int, default=[5])
    p.add_argument("--n", type=int, default=128)
    p.add_argument("--sampling_steps", type=int, default=1000)
    p.add_argument("--eval_dtype", default="bf16")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--gpu", type=str, default=None, help="N for cuda:N, 'cpu' for the plain PyTorch path")
    return p


def main(argv=None) -> Dict:
    args = parser().parse_args(argv)
    return run(args.ckpt, args.budgets, args.lrs, args.epochs, args.n, args.sampling_steps, args.eval_dtype,
               args.out, args.gpu)


if __name__ == "__main__":
    main()
