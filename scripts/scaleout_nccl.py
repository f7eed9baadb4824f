#!/usr/bin/env python3
"""The port's scale-out over NCCL, one process a card (what a user with
several cards runs): the train step of the full-width scratch UNet at
bench.py's global batch of 128 in every layout, then the CLI.

    torchrun --nproc_per_node 4 scripts/scaleout_nccl.py [--out DIR]

Each rank takes ``cuda:LOCAL_RANK`` and joins from torchrun's environment
(``parallel.initialize``), over NCCL. First rank 0 alone times the bare
one-card step at B=128 and at the per-rank batch, and makes the one-rank f32
reference. Then, per layout (replicated; FSDP; TP at model 2; TP + FSDP):
2 f32 steps against that reference (loss and grad norm rtol 1e-4; parameters
within 2·lr a step, all but 1e-3 of them within 1e-6), then bf16 steps with
bench.py's optimizer: the ranks' parameters bitwise equal, each rank's
K1/K2/K3 and bias-shift launches (65, 65, 6; 96 and 96 a step), ms a step (host clock around
synchronised steps), and the share of a step inside the collectives (a
second window in which every collective is timed from a synchronised start
to a synchronised end). Rank 0 prints one JSON line of the numbers, beside
the cards' name and power limit, and writes it to ``DIR/scaleout_nccl.json``.
Any failed check raises; the ranks exit non-zero. Run the CLI the same way:
``torchrun --nproc_per_node 4 -m baddiffusion_tpu_torch.cli ... --gpu 0,1,2,3``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the scale-out phase's helpers)
from baddiffusion_tpu_torch import ops, parallel  # noqa: E402
from baddiffusion_tpu_torch.parallel import distributed  # noqa: E402
from baddiffusion_tpu_torch.parallel import layout as layout_module  # noqa: E402

LAYOUTS = (("replicated", 1, "replicated"), ("fsdp", 1, "fsdp"), ("tp", 2, "replicated"), ("tp_fsdp", 2, "fsdp"))
F32_STEPS, WARM_STEPS, TIMED_STEPS = 2, 2, 5


def timed_steps(state, step, layout, batches, first, n, dev):
    """n bf16 steps from step index ``first``; ms a step (synchronised)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(first, first + n):
        state, m = cs.scale_step(state, step, layout, batches[i % len(batches)], i, dev)
    torch.cuda.synchronize()
    return state, (time.perf_counter() - t0) * 1e3 / n, m


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=".", help="where rank 0 writes its JSON")
    args = parser.parse_args()
    local = distributed.local_rank()
    dev = torch.device("cuda", local)
    backend = distributed.initialize(dev)
    ranks, rank = distributed.world_size(), distributed.rank()
    cs.check(backend == "nccl", f"rank {rank}: joined over {backend}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if rank == 0:
        cs._build.build()
    distributed.barrier("built", timeout_s=600)
    batches = cs.scale_batches(WARM_STEPS + TIMED_STEPS)
    out = {"ranks": ranks, "batch": cs.BATCH, "layouts": {}}

    ref = None
    if rank == 0:  # the one-card baselines and the one-rank f32 reference
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
        out["cards"] = smi
        for rows in (cs.BATCH, cs.BATCH // ranks):
            state, step, _ = cs.scale_world(dev, torch.bfloat16)
            cut = [(image[:rows], is_clean[:rows]) for image, is_clean in batches]
            state, _, _ = timed_steps(state, step, None, cut, 0, WARM_STEPS, dev)
            _, ms, _ = timed_steps(state, step, None, cut, WARM_STEPS, TIMED_STEPS, dev)
            out[f"one_card_ms_at_{rows}"] = ms
            del state, step
        state, step, _ = cs.scale_world(dev, torch.float32)
        metrics = []
        for i in range(F32_STEPS):
            state, m = cs.scale_step(state, step, None, batches[i], i, dev)
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
        ref = (metrics, cs.whole_params(state, None))
        del state, step
        torch.cuda.empty_cache()
    distributed.barrier("reference", timeout_s=1800)

    timer = cs.TimedCollectives()
    for name, mp, sharding in LAYOUTS:
        mesh = parallel.make_mesh(dev, mp)
        rec = out["layouts"][name] = {}
        state, step, layout = cs.scale_world(dev, torch.float32, mesh, sharding)
        metrics = []
        for i in range(F32_STEPS):
            state, m = cs.scale_step(state, step, layout, batches[i], i, dev)
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
        params = cs.whole_params(state, layout)
        if rank == 0:
            rel = np.abs(np.array(metrics) - np.array(ref[0])) / np.abs(np.array(ref[0]))
            diff = torch.cat([(params[k] - ref[1][k]).abs().flatten() for k in ref[1]])
            frac = (diff > 1e-6).double().mean().item()
            cs.check(bool((rel <= 1e-4).all()), f"{name} f32 loss/grad norm {metrics}, one rank {ref[0]}")
            cs.check(diff.max().item() <= 2 * F32_STEPS * cs.TRAIN_LR + 1e-6 and frac <= 1e-3,
                     f"{name} f32 parameters: max diff {diff.max().item():.3g}, {frac:.3g} past 1e-6")
            rec.update(f32_max_rel_err=float(rel.max()), f32_param_max_diff=diff.max().item(), f32_past_1e6=frac)
        del state, step, layout, params
        torch.cuda.empty_cache()

        state, step, layout = cs.scale_world(dev, torch.bfloat16, mesh, sharding)
        state, _, _ = timed_steps(state, step, layout, batches, 0, WARM_STEPS, dev)
        ops.reset_launch_counts()
        state, ms, m = timed_steps(state, step, layout, batches, WARM_STEPS, TIMED_STEPS, dev)
        counts = ops.launch_counts()
        want = cs.scratch_launches(TIMED_STEPS, TIMED_STEPS)
        cs.check(counts == want, f"{name} rank {rank}: launches {counts}, want {want}")
        layout_module.dist = timer  # the second window: every collective timed on its own
        timer.ms = 0.0
        state, timed_ms, _ = timed_steps(state, step, layout, batches, 0, TIMED_STEPS, dev)
        layout_module.dist = torch.distributed
        digest = cs.params_digest(cs.whole_params(state, layout))
        everyone = [None] * ranks
        torch.distributed.all_gather_object(everyone, [digest, float(m["loss"]), counts])
        cs.check(len({d for d, _, _ in everyone}) == 1, f"{name}: the ranks' parameters differ")
        mine = {"ms": ms, "timed_ms": timed_ms, "collective_ms": timer.ms / TIMED_STEPS}
        all_ms = [None] * ranks
        torch.distributed.all_gather_object(all_ms, mine)
        rec.update(per_rank=all_ms, loss=float(m["loss"]), launches=counts)
        del state, step, layout
        torch.cuda.empty_cache()
        if rank == 0:
            print(f"{name} (model {mp}, {sharding}): " + ", ".join(
                f"rank {r} {x['ms']:.1f} ms a step, {100 * x['collective_ms'] / x['timed_ms']:.1f}% in collectives"
                for r, x in enumerate(all_ms)), flush=True)
    if rank == 0:
        line = json.dumps(out)
        print(line, flush=True)
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "scaleout_nccl.json"), "w") as f:
            f.write(line + "\n")
    distributed.barrier("done", timeout_s=600)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
