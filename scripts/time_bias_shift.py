#!/usr/bin/env python3
"""Host time of a ``Conv2d`` and a ``ResnetBlock2D`` call, in this checkout
and in another, compared in one process.

    python3 scripts/time_bias_shift.py --against DIR [--windows N] [--out FILE]

DIR holds another checkout's ``baddiffusion_tpu_torch`` (an older commit
unpacked with ``git archive``, say). Both packages are imported into this
process, each as its own module tree, and timed in alternating windows
(A, B, B, A), so the host's drift between processes and over time falls on
both alike.

What is timed, untraced, after a warm-up, at a tiny shape (a conv of
[1, 4, 4, 32], a resnet of 32 channels with a time embedding), so the
device's pace does not enter: a window enqueues 100 forward calls under
``torch.no_grad`` or 20 forward + backward calls (the backward fed a
cotangent, as a network's is), then synchronises. f32 parameters; bf16 and
f32 activations. Prints the card's name and power limit, each entry's median
and best µs a call over the windows on each side, and one JSON line (also
appended to FILE). Needs a GPU. The shift's device time is timed by
``chip_smoke.py`` (phase ``bias_shift``).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import time

import torch

PKG = "baddiffusion_tpu_torch"
CALLS, GRAD_CALLS = 100, 20


def load_models(root: str):
    """``models`` of the package under ``root``, as a module tree of its
    own: the trees already imported keep running on their own globals."""
    for name in [m for m in sys.modules if m == PKG or m.startswith(PKG + ".")]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(root))
    try:
        return importlib.import_module(PKG + ".models")
    finally:
        sys.path.pop(0)


def entries(models, dev) -> dict:
    """name → (a call, calls a window), on fixed inputs."""
    gen = torch.Generator().manual_seed(0)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        conv = models.Conv2d(32, 32, 3, padding=1).to(dev)
        x = torch.randn(1, 4, 4, 32, generator=gen).to(dev, dtype)
        ct = torch.randn(1, 4, 4, 32, generator=gen).to(dev, dtype)
        xg = x.clone().requires_grad_()
        out[f"conv2d_{name}"] = (torch.no_grad()(lambda conv=conv, x=x: conv(x)), CALLS)
        out[f"conv2d_{name}_fwd_bwd"] = (lambda conv=conv, xg=xg, ct=ct: conv(xg).backward(ct), GRAD_CALLS)
    block = models.ResnetBlock2D(32, 32, 64, groups=8).to(dev)
    x = torch.randn(1, 4, 4, 32, generator=gen).to(dev, torch.bfloat16)
    temb = torch.randn(1, 64, generator=gen).to(dev, torch.bfloat16)
    ct = torch.randn(1, 4, 4, 32, generator=gen).to(dev, torch.bfloat16)
    xg = x.clone().requires_grad_()
    out["resnet_bf16"] = (torch.no_grad()(lambda: block(x, temb)), CALLS)
    out["resnet_bf16_fwd_bwd"] = (lambda: block(xg, temb).backward(ct), GRAD_CALLS)
    return out


def window_us(fn, calls: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--against", required=True, help="the other checkout's root")
    p.add_argument("--windows", type=int, default=40, help="windows a side and entry (an even number)")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("time_bias_shift: needs a GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    torch.backends.cudnn.allow_tf32 = True
    dev = torch.device("cuda")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sides = {"against": entries(load_models(args.against), dev), "this": entries(load_models(here), dev)}
    times = {side: {name: [] for name in sides[side]} for side in sides}
    for name in sides["this"]:
        for side in sides:  # warm-up
            window_us(*sides[side][name])
        for w in range(args.windows):
            for side in (("against", "this") if w % 2 == 0 else ("this", "against")):
                times[side][name].append(window_us(*sides[side][name]))
    result = {"card": smi, "against": args.against, "windows": args.windows,
              "us": {side: {name: [statistics.median(ts), min(ts)] for name, ts in times[side].items()}
                     for side in times}}
    print(f"card: {smi}; host µs a call (median, best), {args.against} → this checkout:")
    for name in sides["this"]:
        (ma, ba), (mt, bt) = result["us"]["against"][name], result["us"]["this"][name]
        print(f"  {name}: {ma:.2f}, {ba:.2f} → {mt:.2f}, {bt:.2f}")
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
