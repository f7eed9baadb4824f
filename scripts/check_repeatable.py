#!/usr/bin/env python3
"""Repeatability of the port's kernels (K1, K2, K3) on the card, at the
shapes ``chip_smoke.py`` phase 2 checks them at.

    python3 scripts/check_repeatable.py [--calls N] [--repeat-only]

Two tests, each bitwise:

1. Shared memory left by an earlier kernel: before each call, a fill kernel
   writes one of five patterns (zeros, ones, a quiet-NaN pair and two
   hashed patterns) over the whole shared memory of every SM; the kernel's
   outputs after each fill must be the same bits. A kernel that reads shared
   memory it did not write shows here.
2. Many calls in a row: K3 at every shape and dtype whose plan runs on the
   tensor cores (``tiled`` and ``wide`` in bf16, ``tf32x3`` and ``tf32x3_wg``
   in f32), N calls
   (default 500; 50 at T = 4096) each compared with the first, with
   ``scaled_dot_product_attention`` run between every third pair.

``--repeat-only`` runs the second test alone (what a run under
``compute-sanitizer`` needs: the fills and the K1/K2 shapes would take it
hours). Prints the card's name and power limit, a line for each shape that differed
(none, when the kernels are sound), the counts, and one JSON line. Exits 1 if
any output differed. Needs a GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the shape tables)
from baddiffusion_tpu_torch import ops  # noqa: E402
from baddiffusion_tpu_torch.ops import _build  # noqa: E402

FILL_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
extern __shared__ uint32_t smem[];
__global__ void fill_smem_kernel(uint32_t pattern, int words) {
  for (int i = threadIdx.x; i < words; i += blockDim.x) smem[i] = pattern ^ (pattern ? i * 2654435761u : 0u);
  __syncthreads();
  if (threadIdx.x == 0 && smem[words - 1] == 12345u) smem[0] = 1u;  // keeps the stores
}
// one block of the largest shared memory per SM, 8 waves: every SM's whole shared memory
extern "C" int fill_smem(unsigned pattern, int sms, void* stream) {
  const int bytes = 227 * 1024;
  cudaError_t err = cudaFuncSetAttribute(fill_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  fill_smem_kernel<<<8 * sms, 1024, bytes, (cudaStream_t)stream>>>(pattern, bytes / 4);
  return (int)cudaGetLastError();
}
"""
PATTERNS = (0x00000000, 0xFFFFFFFF, 0x7FC07FC0, 0x12345678, 0xDEADBEEF)


def fill_library() -> ctypes.CDLL:
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "fill_smem.cu")
    lib = os.path.join(_build.BUILD_DIR, "libfill_smem.so")
    with open(src, "w") as f:
        f.write(FILL_SOURCE)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib, src], check=True)
    fill = ctypes.CDLL(lib).fill_smem
    fill.argtypes = [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]
    return fill


def outputs(result) -> list:
    return [t.clone() for t in (result if isinstance(result, (tuple, list)) else (result,))]


def after_fills(fill, sms: int, label: str, fn) -> int:
    """``fn``'s outputs after each fill pattern, against those after zeros;
    returns how many patterns changed them."""
    runs = []
    for pattern in PATTERNS:
        rc = fill(pattern, sms, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fill_smem failed: cudaError {rc}")
        runs.append(outputs(fn()))
    differ = 0
    for pattern, run in zip(PATTERNS[1:], runs[1:]):
        for i, (a, b) in enumerate(zip(runs[0], run)):
            if not torch.equal(a, b):
                differ += 1
                print(f"   {label} output {i} after fill {pattern:#010x}: {int((a != b).sum())} elements differ, "
                      f"max |d| {(a.float() - b.float()).abs().max().item():.3g}")
    return differ


TENSOR_CORE_PLANS = ("tiled", "tf32x3", "wide", "tf32x3_wg")


def fill_tests(dev, gen, attn: list) -> tuple:
    """The first test at every shape; returns (cases, outputs a fill
    changed, the (shape, dtype) pairs whose plan runs on the tensor cores)."""
    fill = fill_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    groups, eps = chip_smoke.GROUPS, chip_smoke.EPS
    checked = differ = 0
    gn = [(chip_smoke.BATCH, *hwc) for hwc in chip_smoke.GN_SHAPES] + list(chip_smoke.GN_LATENT_SHAPES)
    for b, h, w, c in gn:
        for dtype in (torch.float32, torch.bfloat16):
            x, weight, bias = chip_smoke.gn_inputs(dev, gen, h, w, c, dtype, batch=b)
            ct = torch.randn(b, h, w, c, generator=gen, device=dev).to(dtype)
            _, mean, rstd = ops.groupnorm_silu_forward(x, weight, bias, groups, eps)
            label = f"[{b}, {h}, {w}, {c}] {str(dtype)[6:]}"
            differ += after_fills(fill, sms, f"K1 {label}",
                                  lambda: ops.groupnorm_silu_forward(x, weight, bias, groups, eps))
            differ += after_fills(fill, sms, f"K2 {label}",
                                  lambda: ops.groupnorm_silu_backward(x, weight, bias, mean, rstd, ct, groups))
            checked += 2
    repeat = []
    for shape in attn:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(*shape, generator=gen, device=dev).to(dtype) for _ in range(3))
            scale = shape[3] ** -0.5
            plan = ops.attention_plan(shape[0] * shape[1], shape[2], shape[3], dtype)
            differ += after_fills(fill, sms, f"K3 {list(shape)} {str(dtype)[6:]} ({plan.variant})",
                                  lambda: ops.attention(q, k, v, scale))
            checked += 1
            if plan.variant in TENSOR_CORE_PLANS:
                repeat.append((shape, dtype))
            del q, k, v
    print(f"after {len(PATTERNS)} shared-memory fills: {checked} cases (kernel, shape, dtype), {differ} outputs "
          "changed by a fill")
    return checked, differ, repeat


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--calls", type=int, default=500, help="K3 calls a shape in the second test")
    parser.add_argument("--repeat-only", action="store_true", help="the second test alone")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("check_repeatable: needs a GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.build()
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    attn = list(chip_smoke.ATTN_SHAPES) + list(chip_smoke.ATTN_LATENT_SHAPES)
    checked = differ = 0
    if args.repeat_only:
        repeat = [(s, dtype) for s in attn for dtype in (torch.float32, torch.bfloat16)
                 if ops.attention_plan(s[0] * s[1], s[2], s[3], dtype).variant in TENSOR_CORE_PLANS]
    else:
        checked, differ, repeat = fill_tests(dev, gen, attn)

    calls = calls_differ = 0
    for shape, dtype in repeat:
        q, k, v = (torch.randn(*shape, generator=gen, device=dev).to(dtype) for _ in range(3))
        scale = shape[3] ** -0.5
        first = ops.attention(q, k, v, scale)
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        n_calls = min(args.calls, 50) if shape[2] == 4096 else args.calls
        for i in range(n_calls):
            bad += (ops.attention(q, k, v, scale) != first).sum()
            if i % 3 == 0:
                F.scaled_dot_product_attention(q, k, v, scale=scale)
        n_bad = int(bad)
        calls += n_calls
        if n_bad:
            calls_differ += 1
            print(f"   K3 {list(shape)} {str(dtype)[6:]} ({ops.attention_plan(shape[0] * shape[1], shape[2], shape[3], dtype).variant}): "
                  f"{n_bad} elements differed from the first call over {n_calls} calls")
    print(f"K3 on the tensor cores, {len(repeat)} (shape, dtype) pairs: {calls} calls, {calls_differ} pairs differed")
    print(json.dumps({"fill_checked": checked, "fill_changed": differ, "repeat_calls": calls,
                      "repeat_shapes_differed": calls_differ}))
    return 1 if differ or calls_differ else 0


if __name__ == "__main__":
    sys.exit(main())
