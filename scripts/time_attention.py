#!/usr/bin/env python3
"""Device time of the PyTorch port's attention kernel (K3) in one checkout, at
the shapes ``chip_smoke.py`` checks it at.

    python3 scripts/time_attention.py [--root DIR]

DIR (default: this checkout) holds the ``baddiffusion_tpu_torch`` package to
time. Pointed at an older commit unpacked with ``git archive``, it times that
commit's kernel, so two versions can be compared on one card in one session,
in turns (A, B, B, A). Prints the card's name and power limit, then for each
shape the bf16 device time per call (torch.profiler: the sum of the kernels'
own durations over 20 calls after a warm-up, as ``chip_smoke.py`` measures
it) and the largest |kernel - plain| (the plain version at bf16 tolerance,
atol and rtol 1e-2, as a check that the kernel ran right); then the sums over
a UNet forward's calls at batch 128 and 16, and one JSON line. Where K3 has
a tiled plan, each shape that takes it is also timed at every block height
the kernel takes (16, 32 and 64 query rows): how the plan's rule was chosen.
Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

# [B, H, T, D] -> calls per forward of the 32 px scratch UNet at batch 128
# (chip_smoke.py ATTN_SHAPES)
SHAPES = {
    (128, 64, 4, 8): 5, (128, 64, 1, 8): 1, (16, 64, 4, 8): 0, (16, 64, 1, 8): 0, (4, 64, 256, 8): 0,
    (4, 64, 64, 8): 0, (16, 1, 256, 256): 0, (16, 1, 16, 256): 0, (4, 8, 1024, 64): 0, (2, 1, 256, 512): 0,
    (2, 3, 100, 64): 0,
}
SAMPLING = {(16, 64, 4, 8): 5, (16, 64, 1, 8): 1}
REPS = 20


def device_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profiler session now and then records no device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        ms = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        if ms > 0:
            return ms / 1e3 / REPS
    raise RuntimeError("the profiler recorded no device time in 3 sessions")


def rows_sweep(q, k, v, scale, want) -> dict:
    """The tiled kernel's device time at each block height the plan allows,
    each output checked against the plain version."""
    import importlib

    attn = importlib.import_module("baddiffusion_tpu_torch.ops.attention")
    b, h, t, d = q.shape
    out = torch.empty_like(q)
    result = {}
    for rows in attn.TILED_ROWS:
        plan = attn._tiled_plan(b * h, t, d, rows)
        attn._launch(q, k, v, out, scale, plan)
        if not torch.allclose(out.float(), want, atol=1e-2, rtol=1e-2):
            raise AssertionError(f"tiled plan {plan}: off the plain version")
        result[rows] = device_ms(lambda: attn._launch(q, k, v, out, scale, plan))
        print(f"     tiled, {rows} rows a block ({plan.blocks} blocks): {result[rows]:.4f} ms")
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_attention: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from baddiffusion_tpu_torch import ops  # the package under --root

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    print(f"K3 of {os.path.dirname(os.path.dirname(ops.__file__))}")
    gen = torch.Generator("cuda").manual_seed(0)
    times, sweep = {}, {}
    for (b, h, t, d), _ in SHAPES.items():
        q, k, v = (torch.randn(b, h, t, d, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
        scale = d**-0.5
        label = f"[{b},{h},{t},{d}]"
        got, want = ops.attention(q, k, v, scale).float(), ops.attention_plain(q, k, v, scale).float()
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, atol=1e-2, rtol=1e-2):
            raise AssertionError(f"{label}: kernel off its plain version by {err:.3g}")
        times[label] = device_ms(lambda: ops.attention(q, k, v, scale))
        print(f"   {label} bf16 kernel {times[label]:.4f} ms  max err {err:.3g}")
        if hasattr(ops, "attention_plan") and ops.attention_plan(b * h, t, d, q.dtype).variant == "tiled":
            sweep[label] = rows_sweep(q, k, v, scale, want)
    per_forward = {
        "B=128": sum(n * times[f"[{b},{h},{t},{d}]"] for (b, h, t, d), n in SHAPES.items()),
        "B=16": sum(n * times[f"[{b},{h},{t},{d}]"] for (b, h, t, d), n in SAMPLING.items()),
    }
    print(f"   per UNet forward: B=128 {per_forward['B=128']:.4f} ms, B=16 {per_forward['B=16']:.4f} ms")
    print(json.dumps({"root": os.path.abspath(args.root), "ms": times, "per_forward_ms": per_forward,
                      "rows_sweep_ms": sweep}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
