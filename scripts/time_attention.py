#!/usr/bin/env python3
"""Device time of the PyTorch port's attention kernel (K3) in one checkout, at
the shapes the paths give it, in each dtype a path runs each shape in.

    python3 scripts/time_attention.py [--root DIR] [--reference] [--sweep] [--out FILE]

DIR (default: this checkout) holds the ``baddiffusion_tpu_torch`` package to
time. Pointed at an older commit unpacked with ``git archive``, it times that
commit's kernel, so two versions can be compared on one card in one session,
in turns (A, B, B, A). Prints the card's name and power limit, then for each
shape and dtype the plan, the device time per call (torch.profiler: the sum
of the kernels' own durations over 20 calls after a warm-up, 5 at T = 4096,
as ``chip_smoke.py`` measures it) and the largest |kernel - plain| (held to
``chip_smoke.py``'s tolerances: f32 atol 1e-5, bf16 atol and rtol 1e-2, as a
check that the kernel ran right); then the sums over a UNet forward's calls
at batch 128 and 16, and one JSON line (also written to FILE).

``--reference`` also times the plain twin and ``scaled_dot_product_attention``
at each shape and prints the bound: the largest of the bytes over 3.35 TB/s,
the 4·T²·D products a head over the rate of the plan's arithmetic (the bf16
tensor rate, three TF32 products over the TF32 rate for the f32 tensor-core
plans, else the f32 rate) and the T² exponentials a head over 3.9 T/s.
``--sweep`` times every shape whose plan is ``tiled``, ``tf32x3`` or ``wide``
at each block height the kernel takes (and, for ``wide``, each depth a warp
may own): how the plan's rule was chosen. Needs a GPU.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

BF16, F32 = torch.bfloat16, torch.float32
# [B, H, T, D] -> (the dtypes its paths run it in, calls per forward of the 32 px scratch UNet at batch 128):
# the scratch UNet at 32 px (training at 128, sampling at 16) and at 256 px (micro-batch 4; its measure in
# f32); google/ddpm-cifar10-32 fine-tuned at 128 and sampled at 16 (bf16), its measure (f32, at 16 and at the
# measure's batch, 128); google/ddpm-ema-celebahq-256's 512-wide head in its DDIM chain at 8, its 256 px
# recipe at micro-batch 4 and its f32 measure at 8; the VQ-VAE's mid block at LDM-CELEBA-HQ-256's 64x64
# latent (decode and encode in f32; bf16 too); the LDM UNet's heads of 32 at its three attention
# resolutions (bf16 chains, f32 measure); NCSN++ 256 px at 16x16; the demo models; a ragged T
SHAPES = {
    (128, 64, 4, 8): ((BF16,), 5), (128, 64, 1, 8): ((BF16,), 1), (16, 64, 4, 8): ((BF16,), 0),
    (16, 64, 1, 8): ((BF16,), 0), (4, 64, 256, 8): ((BF16, F32), 0), (4, 64, 64, 8): ((BF16, F32), 0),
    (128, 1, 256, 256): ((BF16, F32), 0), (128, 1, 16, 256): ((BF16, F32), 0),
    (16, 1, 256, 256): ((BF16, F32), 0), (16, 1, 16, 256): ((BF16, F32), 0),
    (8, 1, 256, 512): ((BF16, F32), 0), (8, 1, 64, 512): ((BF16, F32), 0), (4, 1, 256, 512): ((BF16,), 0),
    (4, 1, 64, 512): ((BF16,), 0), (2, 1, 256, 512): ((BF16,), 0), (16, 1, 4096, 512): ((F32, BF16), 0),
    (16, 14, 1024, 32): ((BF16, F32), 0), (16, 21, 256, 32): ((BF16, F32), 0), (16, 28, 64, 32): ((BF16, F32), 0),
    (4, 32, 256, 8): ((BF16, F32), 0), (128, 16, 256, 8): ((BF16,), 0), (128, 32, 64, 8): ((BF16,), 0),
    (16, 16, 256, 8): ((BF16,), 0), (16, 32, 64, 8): ((BF16,), 0), (4, 8, 1024, 64): ((BF16, F32), 0),
    (2, 3, 100, 64): ((BF16, F32), 0),
}
SAMPLING = {(16, 64, 4, 8): 5, (16, 64, 1, 8): 1}
TOL = {F32: dict(atol=1e-5, rtol=0.0), BF16: dict(atol=1e-2, rtol=1e-2)}
# H100 SXM published peaks (as chip_smoke.py): memory, the tensor rates, the f32 rate, exponentials
PEAK_BYTES_PER_S, PEAK_EXP_PER_S = 3.35e12, 3.9e12
PEAK_OPS_PER_S = {"bf16": 989e12, "tf32x3": 495e12 / 3, "f32": 67e12}


def device_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profiler session now and then records no device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        if ms > 0:
            return ms / 1e3 / reps
    raise RuntimeError("the profiler recorded no device time in 3 sessions")


def bound_ms(shape, dtype, variant: str) -> tuple:
    b, h, t, d = shape
    rate = "bf16" if dtype == BF16 else "tf32x3" if variant.startswith("tf32x3") else "f32"
    times = {"bytes": 4 * b * h * t * d * (2 if dtype == BF16 else 4) / PEAK_BYTES_PER_S * 1e3,
             "operations": 4 * b * h * t * t * d / PEAK_OPS_PER_S[rate] * 1e3,
             "exponentials": b * h * t * t / PEAK_EXP_PER_S * 1e3}
    by = max(times, key=times.get)
    return times[by], by


def sweep_plans(attn, shape, dtype, plan) -> list:
    """The plans of ``plan``'s variant at every block height (and, for
    ``wide``, every depth a warp may own) the kernel takes."""
    b, h, t, d = shape
    if plan.variant == "tiled":
        return [attn._tiled_plan(b * h, t, d, rows) for rows in attn.TILED_ROWS]
    if plan.variant in ("tf32x3", "wide"):
        return attn.split_plans(plan.variant, b * h, t, d)
    return []


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--reference", action="store_true", help="also time the plain twin and SDPA")
    parser.add_argument("--sweep", action="store_true", help="time each shape at every plan its variant allows")
    parser.add_argument("--out", help="write the JSON result here too")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_attention: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from baddiffusion_tpu_torch import ops  # the package under --root

    attn = importlib.import_module("baddiffusion_tpu_torch.ops.attention")  # the module, not ops.attention
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    print(f"K3 of {os.path.dirname(os.path.dirname(ops.__file__))}")
    gen = torch.Generator("cuda").manual_seed(0)
    result = {"root": os.path.abspath(args.root), "card": smi, "ms": {}, "plan": {}, "err": {}, "plain_ms": {},
              "sdpa_ms": {}, "bound_ms": {}, "bound_by": {}, "sweep_ms": {}}
    for shape, (dtypes, _) in SHAPES.items():
        b, h, t, d = shape
        scale = d**-0.5
        reps = 5 if t == 4096 else 20
        for dtype in dtypes:
            q, k, v = (torch.randn(b, h, t, d, generator=gen, device="cuda").to(dtype) for _ in range(3))
            key = f"[{b},{h},{t},{d}] {str(dtype)[6:]}"
            plan = ops.attention_plan(b * h, t, d, dtype)
            want = ops.attention_plain(q, k, v, scale).float()
            got = ops.attention(q, k, v, scale).float()
            err = (got - want).abs().max().item()
            if not torch.allclose(got, want, **TOL[dtype]):
                raise AssertionError(f"{key}: kernel off its plain version by {err:.3g} ({plan})")
            del got
            ms = device_ms(lambda: ops.attention(q, k, v, scale), reps)
            result["ms"][key], result["plan"][key], result["err"][key] = ms, plan._asdict(), err
            line = f"   {key} {plan.variant} ({plan.rows} rows, {plan.blocks} blocks): kernel {ms:.4f} ms"
            if args.reference:
                p_ms = device_ms(lambda: ops.attention_plain(q, k, v, scale), reps)
                s_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), reps)
                bnd, by = bound_ms(shape, dtype, plan.variant)
                result["plain_ms"][key], result["sdpa_ms"][key] = p_ms, s_ms
                result["bound_ms"][key], result["bound_by"][key] = bnd, by
                line += (f"  plain {p_ms:.4f}  sdpa {s_ms:.4f}  bound {bnd:.5f} ({by}; kernel/bound {ms / bnd:.1f}, "
                         f"kernel/sdpa {ms / s_ms:.2f})")
            print(f"{line}  max err {err:.3g}", flush=True)
            if args.sweep:
                out = torch.empty_like(q)
                for alt in sweep_plans(attn, shape, dtype, plan):
                    attn._launch(q, k, v, out, scale, alt)
                    if not torch.allclose(out.float(), want, **TOL[dtype]):
                        raise AssertionError(f"{key} under {alt}: off the plain version")
                    alt_ms = device_ms(lambda: attn._launch(q, k, v, out, scale, alt), reps)
                    result["sweep_ms"].setdefault(key, []).append([alt._asdict(), alt_ms])
                    print(f"     {alt.variant}, {alt.rows} rows, {alt.threads} threads, depth {alt.depth}, key tile "
                          f"{alt.key_tile} ({alt.blocks} blocks): {alt_ms:.4f} ms", flush=True)
            del q, k, v, want
    per_forward = {
        "B=128": sum(n * result["ms"][f"[{b},{h},{t},{d}] bfloat16"] for (b, h, t, d), (_, n) in SHAPES.items()),
        "B=16": sum(n * result["ms"][f"[{b},{h},{t},{d}] bfloat16"] for (b, h, t, d), n in SAMPLING.items()),
    }
    result["per_forward_ms"] = per_forward
    print(f"   per UNet forward: B=128 {per_forward['B=128']:.4f} ms, B=16 {per_forward['B=16']:.4f} ms")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"root": result["root"], "ms": result["ms"], "per_forward_ms": per_forward}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
