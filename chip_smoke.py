#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Environment: the card's name and power limit, torch and CUDA versions,
   the kernels' build time (nvcc, from the sources in the checkout). TF32 is
   off for cuDNN and cuBLAS so the f32 checks compare full f32.
2. Kernels against their plain PyTorch versions on the card, at every shape
   the main paths give them (batch 128), in bf16 and f32, with the device
   time (torch.profiler) of the kernel, the plain version and one PyTorch
   library call, and the least time the card could take (bytes over
   3.35 TB/s or operations over peak): GroupNorm+SiLU forward (K1; its
   launch plan printed at each timed shape, its [B, G] statistics against
   the plain ones, output and statistics bitwise equal over two calls, and
   the same checks at the sampling batch 16 and at a 128 px slab too large
   to stage) and backward (K2; its launch plan printed at each timed shape,
   also against autograd through the plain forward, dx, dγ and dβ bitwise
   equal over two calls, the same checks at a 128 px slab too large to
   stage, and the device time of its second kernel, the sum of dγ/dβ over
   the batch, apart), attention (K3; its launch plan printed at each shape:
   the main path's two shapes at batch 128 and 16, the scratch UNet at
   256 px, google/ddpm-cifar10-32, google/ddpm-ema-celebahq-256's 512-wide
   head, the envelope's long end and a ragged T; each in f32 and bf16 against
   the plain version and bitwise equal over two calls; its bound also counts
   the exponentials, over the special-function rate).
3. The sampling path: the full-width scratch UNet (113.7M parameters, 32 px)
   with seeded weights, saved and reloaded through the pipeline's HF layout,
   one f32 forward and a 10-step f32 chain checked against the CPU's plain
   path, then 1000-step bf16 DDPM sampling from noise and from noise +
   trigger (BOX_14); then where the time goes: a profiled 20-step bf16 chain
   and timed bf16 forwards at batch 16 and 128, split by layer.
4. The training path (bench.py's backdoor train step): one f32 step at
   batch 2 on the card against the CPU's plain path (loss, grad norm,
   updated parameters), then bf16-compute steps with f32 parameters at batch
   128 with bench.py's optimizer (lr 2e-4, 500 warmup of 10,000 steps),
   poisoning BOX_14 -> CORNER at rate 0.1: warm-up steps, then timed steps;
   then the device time of a step split into forward, backward and optimizer.
5. Launch counts over each main path's run (the sampling chains of phase 3,
   the timed train steps of phase 4, the two train_loop runs of phase 6,
   the zoo's chains of phase 7; counters set to 0 just before each and read
   just after): every GroupNorm+SiLU and attention call must have gone
   through its kernel, 65 K1 and 6 K3 per UNet forward and, in training, 65
   K2 per step.
6. The trainer path (run after phase 4): train_loop on the scratch UNet at
   bf16 compute with f32 parameters, on DatasetLoader("FAKE", 1024 images,
   32 px, batch 128, seed 0) poisoned BOX_14 -> CORNER at 0.1, with
   bench.py's optimizer, a Tracker, device prefetch, 4x4 sample grids (clean
   and backdoor, with the movie's first frame) and a checkpoint every epoch,
   for 2 epochs; then the checkpoint restored into a fresh model and state
   and train_loop resumed to 3 epochs. The grids sample 50 steps, not 1000
   (phase 3 runs the 1000-step chain): a cut in depth only. Checked: every
   logged loss finite, one metrics.jsonl record a step; every grid a
   138x138x3 PNG; data.json's epoch and step; the restored parameters, Adam
   moments, count and step, and the HF export's weights, bitwise those of the
   live state at the save; the resumed loop's start and end steps; an async
   save, with a train step run before it is finished, read back bitwise.
   Printed: the loop's ms a step and samples/s beside phase 4's bare step,
   a grid's sampling time, a sync save's and the HF export's time, the
   phase's peak memory.

7. The sampler zoo (run after phase 3): the factory's 13 scheduler names
   past DDPM (DDIM, DPM-Solver and DPM-Solver++ of orders 1-3, UniPC, PNDM,
   DEIS, Heun, K-LMS, SDE-VE) and Karras-VE. (a) Each chain with the tests'
   stand-in denoiser, 0.1*x + 0.05*sin(t/100), 10 steps at [16, 32, 32, 3]
   f32, on the card against the CPU from the same init and noise (max err
   <= 1e-4*max|x| + 1e-4). (b) DDIM and DPM-Solver++ O2 on the full-width
   scratch UNet in f32, 5 steps at B=2, card against CPU (rtol 1e-3, atol
   1e-3*max|y|). (c) The path: every chain through DiffusionPipeline on the
   full-width UNet in bf16 at B=16 from noise + trigger (BOX_14), at its
   factory default length (50 steps; SDE-VE 100, not its 2000: a cut in
   depth only), under torch.cuda.set_sync_debug_mode("error"), so that no
   step synchronises; the sample before the clip finite, the images in
   [0, 1], each chain's UNet forwards as designed. (d) Each chain's ms a
   step, imgs/s and forwards; a profiled DPM-Solver++ O2 chain's device ms a
   step and idle share; DPM-Solver++ O2 again at B=128.

The last line is {"ok": true, "device": {...}}; the line before it lists every
kernel with its numbers. Any failed check raises, and the script exits
non-zero. Without CUDA it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from baddiffusion_tpu_torch import factory, ops
from baddiffusion_tpu_torch.data import Backdoor, DatasetLoader, trigger_mask
from baddiffusion_tpu_torch.models import DEFAULT_SCRATCH_CONFIG, UNet2DModel
from baddiffusion_tpu_torch.ops import _build
from baddiffusion_tpu_torch.pipelines import DiffusionPipeline, sample_chain
from baddiffusion_tpu_torch.schedulers import DDPMConfig, DDPMScheduler, KarrasVeScheduler
from baddiffusion_tpu_torch.training import (
    create_train_state,
    finish_async_saves,
    load_trainer_state,
    make_optimizer,
    make_train_step,
    save_checkpoint,
    save_trainer_state,
    train_loop,
)
from baddiffusion_tpu_torch.utils import Tracker

ROOT = os.path.dirname(os.path.abspath(__file__))
TMP_BASE = os.path.join(ROOT, ".chip_smoke_tmp")

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# exponentials per second of the special-function units, H100 SXM5
# (FlashAttention-3, Shah et al., 2024, section 3.1): the softmax's bound
PEAK_EXP_PER_S = 3.9e12

BATCH = 128
GROUPS = 32
EPS = 1e-5
# GroupNorm+SiLU (H, W, C) -> calls per forward of the 32 px scratch UNet
GN_SHAPES = {
    (32, 32, 128): 8, (32, 32, 256): 3, (16, 16, 128): 7, (16, 16, 256): 2, (16, 16, 384): 1,
    (8, 8, 128): 1, (8, 8, 256): 6, (8, 8, 384): 1, (8, 8, 512): 2, (4, 4, 256): 7, (4, 4, 512): 2,
    (4, 4, 768): 1, (2, 2, 256): 1, (2, 2, 512): 6, (2, 2, 768): 1, (2, 2, 1024): 2, (1, 1, 512): 11,
    (1, 1, 1024): 3,
}
GN_FLOPS_PER_ELEMENT = 10  # sum, sum of squares, normalise, affine, SiLU
GN_BWD_FLOPS_PER_ELEMENT = 20  # x-hat, affine, SiLU', two group sums, dγ/dβ sums, dx
# attention [B, H, T, D] -> calls per forward of the main path at batch 128 (0:
# checked and timed, not counted): the 32 px scratch UNet at batch 128 and at
# the sampling batch 16, the scratch UNet at 256 px (micro-batch 4),
# google/ddpm-cifar10-32 at batch 16, the envelope's long end,
# google/ddpm-ema-celebahq-256's one 512-wide head, a ragged T
ATTN_SHAPES = {
    (BATCH, 64, 4, 8): 5, (BATCH, 64, 1, 8): 1, (16, 64, 4, 8): 0, (16, 64, 1, 8): 0, (4, 64, 256, 8): 0,
    (4, 64, 64, 8): 0, (16, 1, 256, 256): 0, (16, 1, 16, 256): 0, (4, 8, 1024, 64): 0, (2, 1, 256, 512): 0,
    (2, 3, 100, 64): 0,
}
ATTN_SAMPLING = {(16, 64, 4, 8): 5, (16, 64, 1, 8): 1}  # a UNet forward at the sampling batch
GN_PER_FORWARD = sum(GN_SHAPES.values())
ATTN_PER_FORWARD = sum(ATTN_SHAPES.values())
TOL = {torch.float32: dict(atol=1e-5, rtol=0.0), torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}

SAMPLE_BATCH = 16
SAMPLE_STEPS = 1000
PROFILE_STEPS = 20
PROFILE_ATTEMPTS = 3
EVENT_TIMED = "(whole window, CUDA events)"  # device_profile's one entry when the profiler recorded nothing
# the train step: bench.py's batch, optimizer and poisoning
TRAIN_LR, TRAIN_WARMUP, TRAIN_TOTAL = 2e-4, 500, 10_000
POISON_RATE = 0.1
TRAIN_WARMUP_CALLS = 3
TRAIN_TIMED_STEPS = 20
TRAIN_PROFILE_STEPS = 3
# the trainer path: FAKE images, epochs of the first run and of the resumed
# one, the grids' batch and chain length (1000 in phase 3: a cut in depth)
TRAINER_FAKE_SIZE = 1024
TRAINER_EPOCHS, TRAINER_RESUME_EPOCHS = 2, 3
TRAINER_SAMPLE_N = 16
TRAINER_SAMPLING_STEPS = 50
GRID_PX = 4 * 32 + 5 * 2  # a 4x4 grid of 32 px images, 2 px borders
# the sampler zoo: the factory's names past DDPM (phase 3 runs DDPM), and Karras-VE
_S = factory.DiffuserModelSched
ZOO_NAMES = (_S.DDIM_SCHED, _S.DPM_SOLVER_PP_O1_SCHED, _S.DPM_SOLVER_O1_SCHED, _S.DPM_SOLVER_PP_O2_SCHED,
             _S.DPM_SOLVER_O2_SCHED, _S.DPM_SOLVER_PP_O3_SCHED, _S.DPM_SOLVER_O3_SCHED, _S.UNIPC_SCHED, _S.PNDM_SCHED,
             _S.DEIS_SCHED, _S.HEUN_SCHED, _S.LMSD_SCHED, _S.SCORE_SDE_VE_SCHED, "KARRAS-VE")
ZOO_STANDIN_SHAPE, ZOO_STANDIN_STEPS = (16, 32, 32, 3), 10
ZOO_F32_CHAINS, ZOO_F32_STEPS = (_S.DDIM_SCHED, _S.DPM_SOLVER_PP_O2_SCHED), 5
ZOO_SDE_STEPS = 100  # SDE-VE's default is 2000: a cut in depth only
# kernel-name fragments -> the layer they belong to, for the device-time breakdown
KERNEL_GROUPS = (
    ("groupnorm_silu (K1)", ("groupnorm_silu_fwd_kernel",)),
    ("groupnorm_silu_backward (K2)", ("groupnorm_silu_bwd_kernel", "sum_rows_kernel")),
    ("attention (K3)", ("attention_packed_kernel", "attention_tiled_kernel", "attention_rowwise_kernel")),
    ("convolution (cuDNN)", ("fprop", "conv", "cutlass", "implicit_gemm", "xmma")),
    ("matmul (cuBLAS)", ("nvjet", "gemm", "cublas")),
)


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def time_ms(fn, reps: int = 20, repeats: int = 5) -> float:
    """Median over ``repeats`` of the CUDA-event time of ``reps`` back-to-back
    calls, per call, after one warm-up call: the wall time a caller pays,
    launch overhead included."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_profile(fn, reps: int = 20):
    """``fn`` run ``reps`` times under torch.profiler after one warm-up call.
    Returns (host wall ms per call, device kernel ms per call,
    {kernel name: device ms per call}, {host op: self host ms per call}); the
    device time is the sum of the kernels' own durations, free of launch
    overhead. Host op times include the profiler's own cost.

    Now and then a profiler session on the card comes back with no device
    events at all (about one session in 200, at times several in a row); the
    window is then measured again, at most ``PROFILE_ATTEMPTS`` times in all,
    and after that timed with CUDA events: its device time is then the
    window's wall time, launch gaps included, under the one name
    ``EVENT_TIMED``, with no host ops."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        kernels = {
            e.key: e.self_device_time_total / 1e3 / reps
            for e in events
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        }
        if kernels:
            host = {e.key: e.self_cpu_time_total / 1e3 / reps for e in events if e.device_type == DeviceType.CPU}
            return wall * 1e3 / reps, sum(kernels.values()), kernels, host
        print(f"   (profiler session {attempt} recorded no device events; measuring again)")
    ms = time_ms(fn, reps=reps, repeats=1)
    print(f"   (no device events in {PROFILE_ATTEMPTS} profiler sessions: this window timed with CUDA events, "
          "launch gaps included)")
    return ms, ms, {EVENT_TIMED: ms}, {}


def device_ms(fn, reps: int = 20) -> float:
    return device_profile(fn, reps)[1]


def top_host_ops(host: dict, per: float, n: int = 8) -> str:
    top = sorted(host.items(), key=lambda kv: -kv[1])[:n]
    return ", ".join(f"{name} {ms / per:.3f} ms" for name, ms in top)


def breakdown(kernels: dict, per: float = 1.0) -> str:
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other (elementwise, copies, cat, plain norms)"] = 0.0
    for key, ms in kernels.items():
        low = key.lower()
        name = next((n for n, frags in KERNEL_GROUPS if any(f in low for f in frags)), None)
        groups[name or "other (elementwise, copies, cat, plain norms)"] += ms
    total = sum(groups.values())
    return ", ".join(f"{n} {v / per:.4f} ms ({100 * v / total:.1f}%)" for n, v in groups.items())


def bound_ms(n_bytes: float, n_ops: float, dtype, n_exp: float = 0.0) -> tuple:
    """The least time the card could take: the largest of the bytes over the
    memory rate, the operations over the tensor (or f32) rate, and the
    exponentials over the special-function rate; and which of them it is."""
    times = {"bytes": n_bytes / PEAK_BYTES_PER_S * 1e3, "operations": n_ops / PEAK_OPS_PER_S[dtype] * 1e3,
             "exponentials": n_exp / PEAK_EXP_PER_S * 1e3}
    by = max(times, key=times.get)
    return times[by], by


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def sum_tol(ref: torch.Tensor) -> dict:
    """Tolerance of an f32 sum over many terms taken in another order:
    1e-4 of the largest reference value."""
    return dict(atol=1e-4 * ref.abs().max().item(), rtol=0.0)


def check_close(label: str, got, want, tols) -> float:
    """Every output within its tolerance; returns the largest abs error."""
    err = 0.0
    for i, (a, b, tol) in enumerate(zip(got, want, tols)):
        e = max_err(a, b)
        err = max(err, e)
        check(a.shape == b.shape and torch.allclose(a.float(), b.float(), **tol),
              f"{label} output {i}: max |kernel - reference| = {e:.3g} (tolerance {tol})")
    return err


def phase_environment() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print("card (nvidia-smi name, power.limit):")
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s) visible")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off for cuDNN convs and cuBLAS matmuls (full f32 for the f32 checks)")
    build_s = _build.build()
    print(f"kernel build: {build_s:.1f} s ({len(_build.SOURCES)} sources, one nvcc each, in parallel)")
    return smi


class KernelRecord:
    """Checks one kernel against its plain twin shape by shape and sums, over
    the main path's calls per UNet forward (or train step), the bf16 device
    times and the bound's bytes and operations."""

    def __init__(self, name: str, source: str, replaces: str, library: str, per: str = "UNet forward",
                 second: str = ""):
        self.entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces}
        self.library = library
        self.per = per
        self.second = second  # the name of a second kernel each call launches, timed apart too
        self.err = 0.0
        self.tot = dict(ms=0.0, second_ms=0.0, wall_ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0, exps=0.0)
        self.times = {}  # label -> the bf16 kernel's device ms per call

    def shape(self, label: str, mult: int, dtype, kernel, plain, library, n_bytes: float, n_ops: float,
              tols=None, n_exp: float = 0.0) -> tuple:
        """``kernel`` and ``plain`` return a tensor or a tuple of them, each
        held to its entry of ``tols`` (default ``TOL[dtype]``). Returns the
        kernel's outputs as a tuple."""
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        got, want = (got,) if torch.is_tensor(got) else got, (want,) if torch.is_tensor(want) else want
        e = check_close(f"{self.entry['name']} {label} {dtype} vs plain", got, want, tols or [TOL[dtype]] * len(got))
        self.err = max(self.err, e)
        if dtype != torch.bfloat16:  # time the main path's dtype only
            return got
        _, k_ms, kern, _ = device_profile(kernel)
        s_ms = sum(ms for key, ms in kern.items() if self.second and self.second in key)
        k_wall, p_ms, l_ms = time_ms(kernel), device_ms(plain), device_ms(library)
        b_ms, b_by = bound_ms(n_bytes, n_ops, dtype, n_exp)
        second = f" ({self.second} {s_ms:.4f} of it)" if self.second else ""
        print(f"   {label} x{mult:2d}  bf16 kernel {k_ms:.4f} ms{second} (per-call wall {k_wall:.4f})  "
              f"plain {p_ms:.4f} ms  {self.library} {l_ms:.4f} ms  bound {b_ms:.5f} ms ({b_by}; kernel/bound "
              f"{k_ms / b_ms:.2f})  max err {e:.3g}")
        self.times[label] = k_ms
        for key, val in (("ms", k_ms), ("second_ms", s_ms), ("wall_ms", k_wall), ("plain_ms", p_ms),
                         ("library_ms", l_ms), ("bytes", n_bytes), ("ops", n_ops), ("exps", n_exp)):
            self.tot[key] += mult * val
        return got

    def summary(self, calls: int) -> dict:
        tot = self.tot
        b_ms, b_by = bound_ms(tot["bytes"], tot["ops"], torch.bfloat16, tot["exps"])
        second = f" ({self.second} {tot['second_ms']:.4f} of it)" if self.second else ""
        print(f"   per {self.per} (B={BATCH}, bf16, {calls} calls): kernel {tot['ms']:.4f} ms{second} "
              f"(per-call wall {tot['wall_ms']:.4f})  plain {tot['plain_ms']:.4f} ms  {self.library} "
              f"{tot['library_ms']:.4f} ms  bound {b_ms:.5f} ms ({tot['bytes'] / 1e9:.3f} GB)")
        return dict(self.entry, max_abs_err=self.err, ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=b_ms,
                    bound_by=b_by, library_ms=tot["library_ms"])


def check_k1_stats_and_repeatable(label: str, x, weight, bias) -> None:
    """K1's saved ``[B, G]`` mean/rstd against the plain ones (mean atol
    1e-6, rstd rtol 1e-5: f32 sums in another order), and its output and
    statistics the same bits over two calls, with and without statistics."""
    first = ops.groupnorm_silu_forward(x, weight, bias, GROUPS, EPS)
    second = ops.groupnorm_silu_forward(x, weight, bias, GROUPS, EPS)
    mean, rstd = ops.groupnorm_stats_plain(x, GROUPS, EPS)
    check_close(f"K1 {label} {x.dtype} statistics vs plain", first[1:], (mean, rstd),
                [dict(atol=1e-6, rtol=0.0), dict(atol=0.0, rtol=1e-5)])
    check(all(torch.equal(a, b) for a, b in zip(first, second))
          and torch.equal(ops.groupnorm_silu(x, weight, bias, GROUPS, EPS), first[0]),
          f"K1 {label} {x.dtype}: output or statistics differ between two calls")


def plan_text(x, plan=ops.groupnorm_silu_plan) -> str:
    b, h, w, c = x.shape
    p = plan(b, h * w, c, GROUPS, x.element_size(), 16)
    return (f"{p.variant}, slab {p.slab_groups} groups ({p.slab_groups * c // GROUPS * x.element_size()} B a pixel), "
            f"packs of {p.vec}, {p.threads} threads, {p.smem_bytes} B shared, {p.blocks} blocks")


def phase_groupnorm(dev, gen) -> dict:
    print(f"-- K1 groupnorm_silu vs groupnorm_silu_plain, B={BATCH}, G={GROUPS}, eps={EPS}; "
          "tolerance f32 atol 1e-5 (sums reordered), bf16 atol 1e-2 rtol 1e-2 in f32 (one bf16 ulp ~0.8%); "
          "[B, G] statistics and bitwise repeatability checked at every shape")
    rec = KernelRecord("groupnorm_silu", "baddiffusion_tpu_torch/csrc/groupnorm_silu.cu",
                       "baddiffusion_tpu/ops/groupnorm.py:135", "F.group_norm+F.silu")
    for (h, w, c), mult in GN_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            x, weight, bias = gn_inputs(dev, gen, h, w, c, dtype)
            x_nchw = x.permute(0, 3, 1, 2)  # channels_last NCHW view for the library call
            w_lib, b_lib = weight.to(dtype), bias.to(dtype)  # torch's group_norm takes them in x's dtype
            label = f"({h:2d},{w:2d},{c:4d})"
            if dtype == torch.bfloat16:
                print(f"   {label} plan: {plan_text(x)}")
            rec.shape(
                label, mult, dtype,
                lambda: ops.groupnorm_silu(x, weight, bias, GROUPS, EPS),
                lambda: ops.groupnorm_silu_plain(x, weight, bias, GROUPS, EPS),
                lambda: F.silu(F.group_norm(x_nchw, GROUPS, w_lib, b_lib, EPS)),
                n_bytes=2 * x.numel() * x.element_size() + 2 * c * 4,
                n_ops=GN_FLOPS_PER_ELEMENT * x.numel(),
            )
            check_k1_stats_and_repeatable(label, x, weight, bias)
    # the sampling path's batch, and a slab too large to stage (two walks over x): checked, and
    # the bf16 kernel's device time
    sampling_ms = 0.0
    for b, (h, w, c) in [(SAMPLE_BATCH, shape) for shape in GN_SHAPES] + [(2, (128, 128, 128))]:
        for dtype in (torch.float32, torch.bfloat16):
            x, weight, bias = gn_inputs(dev, gen, h, w, c, dtype, batch=b)
            label = f"B={b} ({h},{w},{c})"
            got = ops.groupnorm_silu(x, weight, bias, GROUPS, EPS)
            want = ops.groupnorm_silu_plain(x, weight, bias, GROUPS, EPS)
            rec.err = max(rec.err, check_close(f"K1 {label} {dtype} vs plain", (got,), (want,), [TOL[dtype]]))
            check_k1_stats_and_repeatable(label, x, weight, bias)
        k_ms = device_ms(lambda: ops.groupnorm_silu(x, weight, bias, GROUPS, EPS))
        sampling_ms += GN_SHAPES.get((h, w, c), 0) * k_ms if b == SAMPLE_BATCH else 0.0
        print(f"   {label} f32 and bf16 match the plain version, statistics and repeatability checked; bf16 kernel "
              f"{k_ms:.4f} ms; plan (bf16): {plan_text(x)}")
    print(f"   per UNet forward (B={SAMPLE_BATCH}, bf16, {GN_PER_FORWARD} calls): kernel {sampling_ms:.4f} ms")
    return rec.summary(GN_PER_FORWARD)


def gn_inputs(dev, gen, h: int, w: int, c: int, dtype, batch: int = BATCH) -> tuple:
    """x ``[batch, h, w, c]`` in ``dtype``; γ/β f32, as the kernels take them."""
    x = torch.randn(batch, h, w, c, generator=gen, device=dev).to(dtype)
    weight = torch.rand(c, generator=gen, device=dev) + 0.5
    bias = 0.1 * torch.randn(c, generator=gen, device=dev)
    return x, weight, bias


def check_k2_autograd_and_repeatable(label: str, x, weight, bias, ct, got) -> None:
    """K2's outputs ``got`` against autograd through ``groupnorm_silu_plain``,
    and dx, dγ, dβ the same bits on a second call."""
    _, mean, rstd = ops.groupnorm_silu_forward(x, weight, bias, GROUPS, EPS)
    again = ops.groupnorm_silu_backward(x, weight, bias, mean, rstd, ct, GROUPS)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K2 {label} {x.dtype}: dx, dγ or dβ differ between two calls")
    xr, wr, br = (a.detach().clone().requires_grad_() for a in (x, weight, bias))
    auto = torch.autograd.grad(ops.groupnorm_silu_plain(xr, wr, br, GROUPS, EPS), (xr, wr, br), ct)
    dx_tol = (dict(atol=1e-4 * auto[0].abs().max().item(), rtol=1e-4) if x.dtype == torch.float32
              else dict(atol=2e-2, rtol=1e-2))
    check_close(f"K2 {label} {x.dtype} vs autograd", got, auto, [dx_tol, sum_tol(auto[1]), sum_tol(auto[2])])


def phase_groupnorm_backward(dev, gen) -> dict:
    print(f"-- K2 groupnorm_silu_backward vs groupnorm_silu_backward_plain on K1's saved statistics, B={BATCH}, "
          f"G={GROUPS}; tolerance dx f32 atol 1e-5, bf16 atol 1e-2 rtol 1e-2 in f32; dγ/dβ (f32 sums over B·H·W in "
          "another order) atol 1e-4·max|ref|. Against autograd through groupnorm_silu_plain: dx f32 atol "
          "1e-4·max|dx| rtol 1e-4 (other arithmetic), bf16 atol 2e-2 rtol 1e-2 (both round to bf16 once); "
          "dγ/dβ as above. dx, dγ and dβ of two calls must be bitwise equal. Each call is two kernels: "
          "groupnorm_silu_bwd_kernel, then sum_rows_kernel (dγ/dβ summed over B), timed apart too.")
    rec = KernelRecord("groupnorm_silu_backward", "baddiffusion_tpu_torch/csrc/groupnorm_silu_bwd.cu",
                       "baddiffusion_tpu/ops/groupnorm.py:164", "autograd.grad(F.silu(F.group_norm))",
                       per="train step", second="sum_rows_kernel")
    for (h, w, c), mult in GN_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            x, weight, bias = gn_inputs(dev, gen, h, w, c, dtype)
            ct = torch.randn(BATCH, h, w, c, generator=gen, device=dev).to(dtype)
            _, mean, rstd = ops.groupnorm_silu_forward(x, weight, bias, GROUPS, EPS)
            label = f"({h:2d},{w:2d},{c:4d})"
            if dtype == torch.bfloat16:
                print(f"   {label} plan: {plan_text(x, ops.groupnorm_silu_backward_plan)}")

            def kernel():
                return ops.groupnorm_silu_backward(x, weight, bias, mean, rstd, ct, GROUPS)

            def plain():
                return ops.groupnorm_silu_backward_plain(x, weight, bias, mean, rstd, ct, GROUPS)

            # the library call: autograd through torch's group_norm + silu, graph retained
            xl = x.clone().requires_grad_()
            wl, bl = (p.to(dtype).requires_grad_() for p in (weight, bias))
            y_lib = F.silu(F.group_norm(xl.permute(0, 3, 1, 2), GROUPS, wl, bl, EPS))
            ct_nchw = ct.permute(0, 3, 1, 2)
            ref = plain()
            got = rec.shape(
                label, mult, dtype, kernel, plain,
                lambda: torch.autograd.grad(y_lib, (xl, wl, bl), ct_nchw, retain_graph=True),
                n_bytes=3 * x.numel() * x.element_size() + 4 * c * 4 + 2 * BATCH * GROUPS * 4,
                n_ops=GN_BWD_FLOPS_PER_ELEMENT * x.numel(),
                tols=[TOL[dtype], sum_tol(ref[1]), sum_tol(ref[2])],
            )
            check_k2_autograd_and_repeatable(label, x, weight, bias, ct, got)
            del xl, wl, bl, y_lib, ref, got
    # a slab too large to stage (two walks over x and the cotangent): checked, and the bf16 kernel's device time
    b, (h, w, c) = 2, (128, 128, 128)
    label = f"B={b} ({h},{w},{c})"
    for dtype in (torch.float32, torch.bfloat16):
        x, weight, bias = gn_inputs(dev, gen, h, w, c, dtype, batch=b)
        ct = torch.randn(b, h, w, c, generator=gen, device=dev).to(dtype)
        _, mean, rstd = ops.groupnorm_silu_forward(x, weight, bias, GROUPS, EPS)
        got = ops.groupnorm_silu_backward(x, weight, bias, mean, rstd, ct, GROUPS)
        ref = ops.groupnorm_silu_backward_plain(x, weight, bias, mean, rstd, ct, GROUPS)
        rec.err = max(rec.err, check_close(f"K2 {label} {dtype} vs plain", got, ref,
                                           [TOL[dtype], sum_tol(ref[1]), sum_tol(ref[2])]))
        check_k2_autograd_and_repeatable(label, x, weight, bias, ct, got)
    k_ms = device_ms(lambda: ops.groupnorm_silu_backward(x, weight, bias, mean, rstd, ct, GROUPS))
    print(f"   {label} f32 and bf16 match the plain version and autograd, repeatability checked; bf16 kernel "
          f"{k_ms:.4f} ms; plan (bf16): {plan_text(x, ops.groupnorm_silu_backward_plan)}")
    return rec.summary(GN_PER_FORWARD)


def phase_attention(dev, gen) -> dict:
    print("-- K3 attention vs attention_plain; tolerance f32 atol 1e-5 (sums reordered), bf16 atol 1e-2 rtol 1e-2 "
          "in f32 (one bf16 ulp ~0.8%; absorbs the tiled variant's bf16 probabilities); output bitwise equal over two "
          "calls at every shape; bound: the largest of bytes, 4·T²·D products a head over the tensor rate and T² "
          "exponentials a head over the special-function rate")
    rec = KernelRecord("attention", "baddiffusion_tpu_torch/csrc/attention.cu",
                       "baddiffusion_tpu/ops/attention.py:42", "sdpa")
    for (b, h, t, d), mult in ATTN_SHAPES.items():
        scale = 1.0 / d**0.5
        label = f"[{b},{h},{t},{d}]"
        for dtype in (torch.float32, torch.bfloat16):
            print(f"   {label} {str(dtype)[6:]} plan: {ops.attention_plan(b * h, t, d, dtype)}")
            q, k, v = (torch.randn(b, h, t, d, generator=gen, device=dev).to(dtype) for _ in range(3))
            (first,) = rec.shape(
                label, mult, dtype,
                lambda: ops.attention(q, k, v, scale),
                lambda: ops.attention_plain(q, k, v, scale),
                lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                n_bytes=4 * q.numel() * q.element_size(),
                n_ops=4 * b * h * t * t * d,  # the q·k and p·v products
                n_exp=b * h * t * t,  # one exponential a score
            )
            check(torch.equal(first, ops.attention(q, k, v, scale)),
                  f"K3 {label} {dtype}: output differs between two calls")
    sampling_ms = sum(mult * rec.times[f"[{b},{h},{t},{d}]"] for (b, h, t, d), mult in ATTN_SAMPLING.items())
    print(f"   per UNet forward (B={SAMPLE_BATCH}, bf16, {sum(ATTN_SAMPLING.values())} calls): kernel "
          f"{sampling_ms:.4f} ms")
    return rec.summary(ATTN_PER_FORWARD)


def phase_slice(dev, smi: str) -> tuple:
    """Check the slice against the CPU, drive the main path (1000-step
    sampling, clean and backdoor) with the launch counters set to 0 just
    before it, then profile it. Returns (UNet forwards of the main path,
    the launch counts read just after it)."""
    print(f"-- the slice: scratch UNet {DEFAULT_SCRATCH_CONFIG.block_out_channels} at 32 px, seeded weights")
    unet = UNet2DModel(DEFAULT_SCRATCH_CONFIG, generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in unet.parameters())
    check(n_params == 113_673_219, f"scratch UNet has {n_params} parameters")
    os.makedirs(TMP_BASE, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=TMP_BASE) as tmp:
        DiffusionPipeline(unet, DDPMScheduler(DDPMConfig())).save_pretrained(tmp)
        pipe = DiffusionPipeline.from_pretrained(tmp)
    os.rmdir(TMP_BASE)
    sd_a, sd_b = unet.state_dict(), pipe.unet.state_dict()
    check(sd_a.keys() == sd_b.keys() and all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a),
          "weights changed through save_pretrained/from_pretrained")
    print(f"   {n_params} parameters; save_pretrained/from_pretrained round trip exact")

    # f32 forward on the card (kernels) vs the same weights on the CPU (plain path)
    cpu_unet = UNet2DModel(DEFAULT_SCRATCH_CONFIG, device="cpu")
    cpu_unet.load_state_dict(pipe.unet.state_dict())
    gen_cpu = torch.Generator().manual_seed(1)
    x = torch.randn(2, 32, 32, 3, generator=gen_cpu)
    t = torch.tensor([10, 900])
    with torch.no_grad():
        y_card = pipe.unet(x.to(dev), t.to(dev)).cpu()
        y_cpu = cpu_unet(x, t)
    scale = y_cpu.abs().max().item()
    e = max_err(y_card, y_cpu)
    check(torch.allclose(y_card, y_cpu, rtol=1e-3, atol=1e-3 * scale),
          f"f32 UNet forward card vs CPU: max err {e:.3g} (|y| max {scale:.3g})")
    print(f"   f32 forward B=2, card vs CPU plain path: max err {e:.3g}, |y| max {scale:.3g} "
          "(rtol 1e-3, atol 1e-3*max|y|)")

    # a short f32 chain with the same init and noise on both
    noise = [torch.randn(2, 32, 32, 3, generator=gen_cpu) for _ in range(10)]
    cpu_pipe = DiffusionPipeline(cpu_unet, DDPMScheduler(DDPMConfig()), device="cpu")
    ref = cpu_pipe(init=x, num_inference_steps=10, noise_source=noise.__getitem__).images
    got = pipe(init=x, num_inference_steps=10, noise_source=noise.__getitem__).images
    e = float(np.abs(got - ref).max())
    check(e <= 1e-3, f"10-step f32 chain card vs CPU: max image err {e:.3g}")
    print(f"   10-step f32 chain B=2, card vs CPU plain path: max image err {e:.3g} (atol 1e-3)")

    # the main path: 1000-step bf16 sampling, clean and backdoor, counted
    pipe.compute_dtype = torch.bfloat16
    gen = torch.Generator(dev).manual_seed(2)
    noise0 = torch.randn(SAMPLE_BATCH, 32, 32, 3, generator=gen, device=dev)
    trigger = torch.from_numpy(Backdoor().get_trigger("BOX_14", 3, 32)).to(dev)
    forwards = [0]

    def count_forward(module, args):
        if isinstance(module, UNet2DModel) and args[0].is_cuda:
            forwards[0] += 1

    hook = torch.nn.modules.module.register_module_forward_pre_hook(count_forward)
    ops.reset_launch_counts()
    try:
        pipe(init=noise0, generator=gen, num_inference_steps=2)  # warm-up: first bf16 calls set up cuDNN/cuBLAS
        for name, init, movie in (("clean", noise0, False), ("backdoor", noise0 + trigger[None], True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pipe(init=init, generator=gen, num_inference_steps=SAMPLE_STEPS, save_every_step=movie)
            dt = time.perf_counter() - t0
            imgs = out.images
            check(imgs.shape == (SAMPLE_BATCH, 32, 32, 3), f"{name} images shape {imgs.shape}")
            check(bool(np.isfinite(imgs).all()) and imgs.min() >= 0.0 and imgs.max() <= 1.0,
                  f"{name} images not finite in [0, 1]")
            if movie:
                check(out.movie.shape == (50, SAMPLE_BATCH, 32, 32, 3), f"movie shape {out.movie.shape}")
                check(bool(np.array_equal(out.movie[-1], imgs)), "movie's last frame is not the final image")
            print(f"   {SAMPLE_STEPS}-step bf16 DDPM sampling, {name}{' with movie' if movie else ''}, "
                  f"B={SAMPLE_BATCH}: {dt:.2f} s, {SAMPLE_BATCH / dt:.3f} imgs/s, "
                  f"{dt / SAMPLE_STEPS * 1e3:.3f} ms/step, mean pixel {imgs.mean():.4f} on {smi}")
    finally:
        hook.remove()
    counts = ops.launch_counts()

    # where the time goes: a profiled bf16 chain window, and bf16 forwards
    unet_bf16 = pipe.unet.compute_copy(torch.bfloat16)
    bf16_pipe = DiffusionPipeline(unet_bf16, pipe.scheduler)
    wall, dev_ms, kern, host = device_profile(
        lambda: bf16_pipe(init=noise0, generator=gen, num_inference_steps=PROFILE_STEPS), reps=1)
    print(f"   profiled {PROFILE_STEPS}-step bf16 chain B={SAMPLE_BATCH}: {wall / PROFILE_STEPS:.3f} ms/step wall, "
          f"{dev_ms / PROFILE_STEPS:.3f} ms/step device kernels, device idle {100 * (1 - dev_ms / wall):.1f}%")
    print(f"     device time per step: {breakdown(kern, PROFILE_STEPS)}")
    print(f"     host self time per step (profiled): all ops {sum(host.values()) / PROFILE_STEPS:.3f} ms; "
          f"top: {top_host_ops(host, PROFILE_STEPS)}")
    for b in (SAMPLE_BATCH, BATCH):
        xb = torch.randn(b, 32, 32, 3, generator=gen, device=dev)
        tb = torch.randint(0, 1000, (b,), generator=gen, device=dev)
        with torch.inference_mode():
            ms = time_ms(lambda: unet_bf16(xb, tb), reps=10, repeats=3)
            wall, dev_ms, kern, _ = device_profile(lambda: unet_bf16(xb, tb), reps=3)
        print(f"   bf16 UNet forward B={b}: {ms:.3f} ms wall (CUDA events), {dev_ms:.3f} ms device kernels, "
              f"device idle {100 * (1 - dev_ms / ms):.1f}% on {smi}")
        print(f"     device time per forward: {breakdown(kern)}")
    return forwards[0], counts


def zoo_scheduler(name: str) -> tuple:
    """(scheduler, pipeline kind) of a zoo name: the factory's, or Karras-VE's defaults."""
    if name == "KARRAS-VE":
        return KarrasVeScheduler(), "karras"
    make, kind = factory._sched_spec(name)
    return make(factory.DiffuserModelSched.CLIP_SAMPLE_DEFAULT), kind


def zoo_steps(name: str, kind: str) -> int:
    return ZOO_SDE_STEPS if kind == "sde" else factory.PIPELINE_DEFAULT_STEPS[kind]


def zoo_forwards(scheduler, kind: str, n: int) -> tuple:
    """(scheduler steps, UNet forwards) of an n-step chain, as each engine is
    designed: one forward a step for the generic chain (len(timesteps):
    n, PNDM's PRK and PLMS steps, Heun's 2n - 1); SDE-VE correct_steps + 1
    a step; Karras-VE two a step, one on the last (σ_prev = 0)."""
    steps = len(scheduler.set_timesteps(scheduler.create_state(), n).timesteps)
    if kind == "sde":
        return steps, steps * (scheduler.config.correct_steps + 1)
    if kind == "karras":
        return steps, 2 * steps - 1
    return steps, steps


def standin(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The tests' deterministic stand-in denoiser, per sample."""
    return 0.1 * x + 0.05 * torch.sin(t.float() / 100.0).view(-1, 1, 1, 1)


def phase_zoo(dev, smi: str) -> tuple:
    """Phase 7: the zoo's scheduler arithmetic and the f32 UNet chains on the
    card against the CPU, then every chain on the full-width UNet in bf16 at
    B=16 with the launch counters set to 0 just before and read just after,
    each step under the sync guard; then the numbers. Returns (UNet
    forwards, the launch counts)."""
    print(f"-- the sampler zoo: {len(ZOO_NAMES)} chains ({', '.join(ZOO_NAMES)})")
    phase_t0 = time.perf_counter()
    gen_cpu = torch.Generator().manual_seed(70)

    # (a) the scheduler arithmetic: stand-in chains, card against CPU, same init and noise
    init = torch.randn(ZOO_STANDIN_SHAPE, generator=gen_cpu)
    noise = [torch.randn(ZOO_STANDIN_SHAPE, generator=gen_cpu) for _ in range(4 * ZOO_STANDIN_STEPS)]
    noise_card = [z.to(dev) for z in noise]
    worst = 0.0
    for name in ZOO_NAMES:
        out = {}
        for device, source in (("cpu", noise), ("cuda", noise_card)):
            scheduler, _ = zoo_scheduler(name)
            state = scheduler.set_timesteps(scheduler.create_state(), ZOO_STANDIN_STEPS)
            out[device], _ = sample_chain(scheduler, state, standin, init.to(device), noise_source=source.__getitem__)
        ref, got = out["cpu"], out["cuda"].cpu()
        scale = ref.abs().max().item()
        e = max_err(got, ref)
        check(bool(torch.isfinite(got).all()) and e <= 1e-4 * scale + 1e-4,
              f"zoo {name} stand-in chain card vs CPU: max err {e:.3g} (max|x| {scale:.3g})")
        worst = max(worst, e / (1e-4 * scale + 1e-4))
        print(f"   (a) {name:24s} stand-in {ZOO_STANDIN_STEPS} steps {list(ZOO_STANDIN_SHAPE)} f32, card vs CPU: "
              f"max err {e:.3g}, max|x| {scale:.4g}")
    print(f"   (a) every stand-in chain within max err <= 1e-4*max|x| + 1e-4 (worst at {worst:.3f} of its bound); "
          f"{time.perf_counter() - phase_t0:.1f} s")

    # (b) the full-width UNet in f32: card against CPU
    unet = UNet2DModel(DEFAULT_SCRATCH_CONFIG, generator=torch.Generator().manual_seed(0))
    cpu_unet = UNet2DModel(DEFAULT_SCRATCH_CONFIG, device="cpu")
    cpu_unet.load_state_dict(unet.state_dict())
    x = torch.randn(2, 32, 32, 3, generator=gen_cpu)
    for name in ZOO_F32_CHAINS:
        out = {}
        for device, model in (("cpu", cpu_unet), ("cuda", unet)):
            scheduler, kind = zoo_scheduler(name)
            pipe = factory._make_get_pipeline(model, kind, False)(scheduler, device=device)
            out[device] = pipe(init=x, num_inference_steps=ZOO_F32_STEPS, output_type="pt").sample.cpu()
        ref, got = out["cpu"], out["cuda"]
        scale = ref.abs().max().item()
        e = max_err(got, ref)
        check(torch.allclose(got, ref, rtol=1e-3, atol=1e-3 * scale),
              f"zoo {name} f32 UNet chain card vs CPU: max err {e:.3g} (max|y| {scale:.3g})")
        print(f"   (b) {name:24s} full-width UNet f32, {ZOO_F32_STEPS} steps B=2, card vs CPU: max err {e:.3g}, "
              f"max|y| {scale:.4g} (rtol 1e-3, atol 1e-3*max|y|)")
    del cpu_unet
    print(f"   (b) done at {time.perf_counter() - phase_t0:.1f} s into the phase")

    # (c) the path: bf16 chains at B=16 from noise + trigger, counted, each under the sync guard
    gen = torch.Generator(dev).manual_seed(71)
    trigger = torch.from_numpy(Backdoor().get_trigger("BOX_14", 3, 32)).to(dev)
    init = torch.randn(SAMPLE_BATCH, 32, 32, 3, generator=gen, device=dev) + trigger[None]
    forwards = [0]

    def count_forward(module, args):
        if isinstance(module, UNet2DModel) and args[0].is_cuda:
            forwards[0] += 1

    def pipeline(name):
        scheduler, kind = zoo_scheduler(name)
        return factory._make_get_pipeline(unet, kind, False)(scheduler, compute_dtype=torch.bfloat16), kind

    pipeline(_S.DDIM_SCHED)[0](init=init, generator=gen, num_inference_steps=2)  # warm-up: bf16 algorithms
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # the guard is live: it refuses a read-back
    try:
        init.sum().item()
        caught = False
    except RuntimeError:
        caught = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(caught, "zoo: torch.cuda.set_sync_debug_mode('error') let a .item() through")
    rows = []
    hook = torch.nn.modules.module.register_module_forward_pre_hook(count_forward)
    ops.reset_launch_counts()
    try:
        for name in ZOO_NAMES:
            pipe, kind = pipeline(name)
            n = zoo_steps(name, kind)
            steps, want = zoo_forwards(pipe.scheduler, kind, n)
            before = forwards[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = pipe(init=init, generator=gen, num_inference_steps=n, output_type="pt")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got = forwards[0] - before
            peak = out.sample.abs().max().item()
            images = out.images
            check(got == want, f"zoo {name}: {got} UNet forwards, designed {want}")
            check(bool(torch.isfinite(out.sample).all()), f"zoo {name}: the sample before the clip is not finite")
            check(images.shape == (SAMPLE_BATCH, 32, 32, 3) and images.min().item() >= 0.0
                  and images.max().item() <= 1.0, f"zoo {name}: images not in [0, 1]")
            rows.append((name, n, steps, got, dt))
            print(f"   (c) {name:24s} {n:3d} steps ({steps} scheduler steps), {got:3d} forwards, bf16 B={SAMPLE_BATCH}: "
                  f"{dt:.3f} s, {dt / steps * 1e3:.3f} ms/step, {dt / got * 1e3:.3f} ms/forward, "
                  f"{SAMPLE_BATCH / dt:.3f} imgs/s; max|x| before the clip {peak:.4g}, mean pixel "
                  f"{images.mean().item():.4f}; no step synchronised")

        # (d) a profiled DPM-Solver++ O2 chain, and the same chain at B=128
        pipe, kind = pipeline(_S.DPM_SOLVER_PP_O2_SCHED)
        n = zoo_steps(_S.DPM_SOLVER_PP_O2_SCHED, kind)
        wall, dev_ms, kern, host = device_profile(
            lambda: pipe(init=init, generator=gen, num_inference_steps=n, output_type="pt"), reps=1)
        print(f"   (d) profiled DPM-Solver++ O2 chain, {n} steps bf16 B={SAMPLE_BATCH}: {wall / n:.3f} ms/step wall, "
              f"{dev_ms / n:.3f} ms/step device kernels, device idle {100 * (1 - dev_ms / wall):.1f}% on {smi}")
        print(f"     device time per step: {breakdown(kern, n)}")
        print(f"     host self time per step (profiled): all ops {sum(host.values()) / n:.3f} ms; "
              f"top: {top_host_ops(host, n)}")
        big = torch.randn(BATCH, 32, 32, 3, generator=gen, device=dev) + trigger[None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe(init=big, generator=gen, num_inference_steps=n, output_type="pt")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(bool(torch.isfinite(out.sample).all()), "zoo DPM-Solver++ O2 at B=128: sample not finite")
        print(f"   (d) DPM-Solver++ O2 {n} steps bf16 B={BATCH}: {dt:.3f} s, {dt / n * 1e3:.3f} ms/step, "
              f"{BATCH / dt:.2f} imgs/s on {smi}")
    finally:
        hook.remove()
    counts = ops.launch_counts()
    total = sum(r[3] for r in rows)
    print(f"   (c) {len(rows)} chains, {total} forwards in {sum(r[4] for r in rows):.2f} s; phase 7 took "
          f"{time.perf_counter() - phase_t0:.1f} s on {smi}")
    return forwards[0], counts


def seeded_scratch_unet(device, dtype=torch.float32) -> UNet2DModel:
    """The full-width scratch UNet from seed 0, with its biases and GroupNorm
    affines moved off 0 and 1 (from seed 1) so their gradients count."""
    unet = UNet2DModel(DEFAULT_SCRATCH_CONFIG, device=device, generator=torch.Generator().manual_seed(0), dtype=dtype)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in unet.named_parameters():
            if name.endswith("bias") or ("norm" in name and name.endswith("weight")):
                p.add_((0.05 * torch.randn(p.shape, generator=g)).to(p.device))
    return unet


def train_batch(rng: np.random.RandomState, b: int) -> tuple:
    """A uint8 NHWC batch and its is_clean flags: rows poisoned at
    POISON_RATE, at least one clean and one poisoned."""
    image = rng.randint(0, 256, (b, 32, 32, 3)).astype(np.uint8)
    is_clean = rng.rand(b) >= POISON_RATE
    is_clean[:2] = (True, False)
    return image, is_clean


def phase_train(dev, smi: str) -> tuple:
    """Check one f32 train step against the CPU, drive the main path (bf16
    steps at batch 128) with the launch counters set to 0 just before the
    timed steps, then split a step's device time. Returns (timed steps, the
    launch counts read just after them)."""
    print(f"-- the training path: scratch UNet {DEFAULT_SCRATCH_CONFIG.block_out_channels} at 32 px, f32 "
          "parameters, poison BOX_14 -> CORNER")
    bd = Backdoor()
    trigger = bd.get_trigger("BOX_14", 3, 32)
    target = bd.get_target("CORNER", trigger)
    consts = (trigger, target, trigger_mask(trigger))
    schedule = DDPMScheduler(DDPMConfig()).create_state().schedule
    rng = np.random.RandomState(3)

    # one f32 step at batch 2, no warmup: the card (kernels) against the CPU (plain path)
    image, is_clean = train_batch(rng, 2)
    t, noise = rng.randint(0, 1000, 2), rng.randn(2, 32, 32, 3).astype(np.float32)
    weights = seeded_scratch_unet("cpu").state_dict()
    result = {}
    for device in ("cuda", "cpu"):
        unet = UNet2DModel(DEFAULT_SCRATCH_CONFIG, device=device)
        unet.load_state_dict(weights)
        opt, _ = make_optimizer(TRAIN_LR, num_warmup_steps=0, num_training_steps=TRAIN_TOTAL)
        state = create_train_state(unet, opt, *consts)
        step = make_train_step(unet, opt, 1000, schedule.alphas, schedule.alphas_cumprod, device=device)
        state, m = step(state, image, is_clean, None, timesteps=t, noise=noise)
        result[device] = ({k: float(v) for k, v in m.items()}, {k: p.detach().cpu() for k, p in state.params.items()})
        del unet, opt, state, step
    (m_card, p_card), (m_cpu, p_cpu) = result["cuda"], result["cpu"]
    for key in ("loss", "grad_norm"):
        rel = abs(m_card[key] - m_cpu[key]) / abs(m_cpu[key])
        check(rel <= 1e-4, f"f32 train step {key}: card {m_card[key]!r} CPU {m_cpu[key]!r}")
        print(f"   f32 step B=2, card vs CPU plain path: {key} {m_card[key]:.6f} vs {m_cpu[key]:.6f}, "
              f"rel err {rel:.3g} (rtol 1e-4)")
    diff = torch.cat([(p_card[k] - p_cpu[k]).abs().flatten() for k in p_cpu])
    moved = torch.cat([(p_cpu[k] - weights[k]).abs().flatten() for k in p_cpu])
    frac = (diff > 1e-6).double().mean().item()
    # Adam's first step is lr·g/(|g|+eps): ±lr wherever |g| >> eps, so only
    # elements whose gradient is within rounding of 0 may differ, by up to 2·lr
    check(diff.max().item() <= 2 * TRAIN_LR + 1e-6 and frac <= 1e-3,
          f"f32 train step params: max diff {diff.max().item():.3g}, {frac:.3g} of them past 1e-6")
    print(f"   updated params card vs CPU: max diff {diff.max().item():.3g}, {frac:.3g} of {diff.numel()} past 1e-6 "
          f"(tolerance: max <= 2*lr = {2 * TRAIN_LR:g}, at most 1e-3 past 1e-6); largest move {moved.max().item():.3g}")
    del result, p_card, p_cpu, diff, moved

    # the main path: bf16 compute, f32 parameters, batch 128, bench.py's optimizer
    unet = seeded_scratch_unet(dev, dtype=torch.bfloat16)
    opt, _ = make_optimizer(TRAIN_LR, num_warmup_steps=TRAIN_WARMUP, num_training_steps=TRAIN_TOTAL)
    state = create_train_state(unet, opt, *consts)
    step = make_train_step(unet, opt, 1000, schedule.alphas, schedule.alphas_cumprod)
    image, is_clean = (torch.from_numpy(a).to(dev) for a in train_batch(rng, BATCH))
    gen = torch.Generator(dev).manual_seed(4)
    before = [p.detach().clone() for p in state.params.values()]
    for _ in range(TRAIN_WARMUP_CALLS):  # first calls set up cuDNN/cuBLAS
        state, m = step(state, image, is_clean, gen)
    torch.cuda.synchronize()
    metrics = []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED_STEPS):
        state, m = step(state, image, is_clean, gen)
        metrics.append(torch.stack([m["loss"], m["grad_norm"]]))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    metrics = torch.stack(metrics).cpu()
    check(bool(torch.isfinite(metrics).all()), f"bf16 train steps: loss or grad norm not finite: {metrics}")
    # a tensor may stay put only where its gradient is exactly 0: the mid
    # block's attention sees one pixel (T = 1), where softmax over one key
    # passes no gradient to its query and key projections
    unchanged = [k for (k, p), b in zip(state.params.items(), before) if torch.equal(p, b)]
    check(all(not state.params[k].grad.any() for k in unchanged),
          f"parameter tensors with a gradient unchanged after the train steps: {unchanged}")
    check(len(unchanged) < len(before), "no parameter changed in the train steps")
    del before
    ms_step = dt / TRAIN_TIMED_STEPS * 1e3
    print(f"   {TRAIN_TIMED_STEPS} bf16 train steps B={BATCH} after {TRAIN_WARMUP_CALLS} warm-up steps: "
          f"{BATCH * TRAIN_TIMED_STEPS / dt:.1f} samples/s, {ms_step:.3f} ms/step on {smi}; "
          f"loss {metrics[0, 0]:.4f} -> {metrics[-1, 0]:.4f}, grad norm {metrics[0, 1]:.4f} -> {metrics[-1, 1]:.4f}, "
          f"all finite; {len(state.params) - len(unchanged)} of {len(state.params)} parameter tensors changed, "
          f"unchanged (zero gradient): {unchanged}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    # where the time goes: device time of the forward (loss), forward + backward, and the whole step
    params = list(state.params.values())

    def forward():
        step.loss(state, image, is_clean, gen)

    def forward_backward():
        for p in params:
            p.grad = None
        step.loss(state, image, is_clean, gen).backward()

    def whole_step():
        step(state, image, is_clean, gen)

    f_ms = device_ms(forward, reps=TRAIN_PROFILE_STEPS)
    fb_ms = device_ms(forward_backward, reps=TRAIN_PROFILE_STEPS)
    wall, s_ms, kern, host = device_profile(whole_step, reps=TRAIN_PROFILE_STEPS)
    print(f"   profiled bf16 train step B={BATCH}: {wall:.3f} ms wall, {s_ms:.3f} ms device kernels, device idle "
          f"{100 * (1 - s_ms / wall):.1f}% (against the unprofiled {ms_step:.3f} ms/step: "
          f"{100 * (1 - s_ms / ms_step):.1f}%)")
    print(f"     device time per step: forward {f_ms:.3f} ms, backward {fb_ms - f_ms:.3f} ms, "
          f"optimizer (clip, Adam, zeroing) {s_ms - fb_ms:.3f} ms")
    print(f"     device time per step by layer: {breakdown(kern)}")
    print(f"     host self time per step (profiled): all ops {sum(host.values()):.3f} ms; top: {top_host_ops(host, 1)}")
    print("     host self time per step of the GroupNorm+SiLU autograd Functions (K1 forward, K2 backward): "
          + ", ".join(f"{name} {ms:.3f} ms" for name, ms in host.items() if "GroupNormSiLU" in name))
    return TRAIN_TIMED_STEPS, counts, ms_step


def state_tensors(state) -> dict:
    """Every tensor of a TrainState by checkpoint key, and its two counters."""
    names = list(state.params)
    out = {f"params/{k}": p.detach() for k, p in state.params.items()}
    out.update({f"mu/{k}": m for k, m in zip(names, state.opt_state.mu)})
    out.update({f"nu/{k}": v for k, v in zip(names, state.opt_state.nu)})
    out.update(count=state.opt_state.count, step=state.step)
    return out


def check_same_state(label: str, got: dict, want: dict) -> None:
    check(got.keys() == want.keys(), f"{label}: the state's keys differ")
    bad = [k for k in want if not (torch.equal(got[k], want[k]) if torch.is_tensor(want[k]) else got[k] == want[k])]
    check(not bad, f"{label}: not bitwise equal: {bad[:5]} ({len(bad)} of {len(want)})")


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def check_grids(run_dir: str, epochs) -> None:
    """Each epoch's clean and backdoor grid and first-frame grid: a
    GRID_PX x GRID_PX RGB PNG with finite, varied pixels."""
    from PIL import Image

    for e in epochs:
        for sub in ("samples", "backdoor_samples"):
            for name in (f"ep{e}.png", f"ep{e}_t0.png"):
                path = os.path.join(run_dir, sub, name)
                check(os.path.exists(path), f"trainer: grid {sub}/{name} missing (a swallowed sampling failure?)")
                with Image.open(path) as img:
                    arr = np.asarray(img)
                check(arr.shape == (GRID_PX, GRID_PX, 3) and arr.std() > 0, f"trainer: grid {sub}/{name} is {arr.shape}")


def step_ms(records) -> list:
    """Wall ms between consecutive logged steps of one epoch (each log reads
    the loss, so each record follows its step's end on the device)."""
    return [1e3 * (b["_time"] - a["_time"]) for a, b in zip(records, records[1:])
            if b["_step"] == a["_step"] + 1 and b["epoch"] == a["epoch"]]


def phase_trainer(dev, smi: str, bare_ms: float) -> tuple:
    """Drive train_loop for TRAINER_EPOCHS, restore its checkpoint into a
    fresh model and state, resume to TRAINER_RESUME_EPOCHS, and check the
    run's outputs. Launch counters are set to 0 just before each loop and
    read just after. Returns (train steps, sampling forwards, the summed
    launch counts)."""
    print(f"-- the trainer path: train_loop on the scratch UNet, bf16 compute on f32 parameters; FAKE "
          f"{TRAINER_FAKE_SIZE} images at 32 px, batch {BATCH}, BOX_14 -> CORNER at {POISON_RATE}; bench.py's "
          f"optimizer; grids ({TRAINER_SAMPLE_N} images, with movie) and a checkpoint every epoch; "
          f"{TRAINER_EPOCHS} epochs, then resumed to {TRAINER_RESUME_EPOCHS}. The grids sample "
          f"{TRAINER_SAMPLING_STEPS} steps, not 1000 (phase 3 runs the 1000-step chain): a cut in depth only")
    # no network here: wandb, where installed, stays off (the checks read the JSONL stream)
    os.environ["WANDB_MODE"] = "disabled"
    phase_t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    os.makedirs(TMP_BASE, exist_ok=True)
    run_dir = tempfile.mkdtemp(dir=TMP_BASE)
    try:
        dsl = DatasetLoader("FAKE", fake_size=TRAINER_FAKE_SIZE, image_size=32, batch_size=BATCH, seed=0, root=run_dir)
        dsl.set_poison("BOX_14", "CORNER", poison_rate=POISON_RATE).prepare_dataset()
        per_epoch = dsl.num_batch
        scheduler = DDPMScheduler(DDPMConfig())
        schedule = scheduler.create_state().schedule
        opt, lr_schedule = make_optimizer(TRAIN_LR, num_warmup_steps=TRAIN_WARMUP, num_training_steps=TRAIN_TOTAL)
        call_s = []  # wall seconds of each pipeline call the grids make

        class TimedPipeline(DiffusionPipeline):
            def __call__(self, *args, **kwargs):
                t0 = time.perf_counter()
                out = super().__call__(*args, **kwargs)  # returns host arrays: the device is done
                call_s.append(time.perf_counter() - t0)
                return out

        def trainer(unet):
            state = create_train_state(unet, opt, dsl.trigger, dsl.target, dsl.mask)
            step = make_train_step(unet, opt, 1000, schedule.alphas, schedule.alphas_cumprod)
            return state, step, lambda st: TimedPipeline(unet, scheduler, compute_dtype=torch.bfloat16)

        def run(state, step, make_pipeline, epochs, start_epoch=0, start_step=0):
            tracker = Tracker(os.path.join(run_dir, "logs"), config=dict(batch=BATCH, lr=TRAIN_LR, epochs=epochs))
            forwards = [0]

            def count_forward(module, args):
                if isinstance(module, UNet2DModel) and args[0].is_cuda:
                    forwards[0] += 1

            hook = torch.nn.modules.module.register_module_forward_pre_hook(count_forward)
            grids_before = len(call_s)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                state, global_step = train_loop(
                    dsl=dsl, train_step=step, state=state, lr_schedule=lr_schedule, epochs=epochs, tracker=tracker,
                    out_dir=run_dir, make_pipeline=make_pipeline, seed=0, start_epoch=start_epoch,
                    start_step=start_step, save_image_epochs=1, save_model_epochs=1, log_every=1,
                    sample_n=TRAINER_SAMPLE_N, sampling_steps=TRAINER_SAMPLING_STEPS)
            finally:
                hook.remove()
                tracker.close()
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            sampled = (len(call_s) - grids_before) * TRAINER_SAMPLING_STEPS
            check(forwards[0] == global_step - start_step + sampled,
                  f"trainer: {forwards[0]} UNet forwards, want {global_step - start_step} train + {sampled} sampling")
            return state, global_step, counts, sampled, time.perf_counter() - t0

        # the first run: epochs 0 .. TRAINER_EPOCHS-1 from step 0
        unet = seeded_scratch_unet(dev, dtype=torch.bfloat16)
        state, step, make_pipeline = trainer(unet)
        state, end1, counts1, sampled1, wall1 = run(state, step, make_pipeline, TRAINER_EPOCHS)
        steps1 = TRAINER_EPOCHS * per_epoch
        check(end1 == state.step == state.opt_state.count == steps1, f"trainer: first run ended at step {end1}")
        check_grids(run_dir, range(TRAINER_EPOCHS))
        saved = read_json(os.path.join(run_dir, "data.json"))
        check(saved == {"epoch": TRAINER_EPOCHS - 1, "step": steps1, "ckpt": "ckpt"}, f"trainer: data.json {saved}")
        live = state_tensors(state)

        # restore into a fresh model and state; the HF export from the same save
        fresh = UNet2DModel(DEFAULT_SCRATCH_CONFIG, generator=torch.Generator().manual_seed(9), dtype=torch.bfloat16)
        state2, step2, make_pipeline2 = trainer(fresh)
        state2, start_epoch, start_step = load_trainer_state(run_dir, state2)
        check((start_epoch, start_step) == (TRAINER_EPOCHS - 1, steps1),
              f"trainer: restored at epoch {start_epoch}, step {start_step}")
        check_same_state("trainer: restored state vs the live state at the save", state_tensors(state2), live)
        exported = DiffusionPipeline.from_pretrained(run_dir).unet.state_dict()
        check_same_state("trainer: HF export vs the live parameters at the save",
                         {f"params/{k}": exported[k] for k in state.params},
                         {k: v for k, v in live.items() if k.startswith("params/")})
        del exported
        print(f"   first run: {end1} steps over {TRAINER_EPOCHS} epochs in {wall1:.2f} s; data.json {saved}; restored "
              "parameters, mu, nu, count and step bitwise equal to the live state; HF export bitwise equal")

        # the resumed run re-runs the saved epoch, as the reference's resume does
        state2, end2, counts2, sampled2, wall2 = run(state2, step2, make_pipeline2, TRAINER_RESUME_EPOCHS,
                                                     start_epoch, start_step)
        steps2 = (TRAINER_RESUME_EPOCHS - start_epoch) * per_epoch
        check(end2 == state2.step == state2.opt_state.count == start_step + steps2,
              f"trainer: resumed run ended at step {end2}, want {start_step + steps2}")
        check_grids(run_dir, range(TRAINER_RESUME_EPOCHS))
        saved = read_json(os.path.join(run_dir, "data.json"))
        check(saved == {"epoch": TRAINER_RESUME_EPOCHS - 1, "step": end2, "ckpt": "ckpt"},
              f"trainer: data.json after the resume {saved}")
        with open(os.path.join(run_dir, "logs", "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        losses = [r["loss"] for r in records]
        check([r["_step"] for r in records] == list(range(steps1)) + list(range(start_step, end2)),
              f"trainer: metrics.jsonl steps {[r['_step'] for r in records]}")
        check(records[steps1]["epoch"] == start_epoch and bool(np.isfinite(losses).all()),
              f"trainer: resumed at epoch {records[steps1]['epoch']}, losses {losses}")
        print(f"   resumed run: epoch {start_epoch}, step {start_step} -> step {end2} in {wall2:.2f} s; "
              f"{len(records)} records, one a step, every loss finite: {losses[0]:.4f} -> {losses[-1]:.4f}")

        # timings: the loop's step from the tracker's stamps, the grids, a sync save and the HF export
        gaps = step_ms(records[:steps1]) + step_ms(records[steps1:])
        loop_ms = statistics.median(gaps)
        grid_s = [a + b for a, b in zip(call_s[::2], call_s[1::2])]
        save_dir = os.path.join(run_dir, "timed")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_trainer_state(save_dir, state2, TRAINER_RESUME_EPOCHS - 1)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        make_pipeline2(state2).save_pretrained(save_dir)
        export_s = time.perf_counter() - t0
        state_gb = sum(t.numel() * t.element_size() for t in state_tensors(state2).values() if torch.is_tensor(t)) / 1e9
        print(f"   train_loop step B={BATCH} (median of {len(gaps)} step-to-step gaps within an epoch): {loop_ms:.3f} "
              f"ms/step, {BATCH / loop_ms * 1e3:.1f} samples/s (mean {statistics.mean(gaps):.3f} ms); phase 4's bare "
              f"step {bare_ms:.3f} ms/step; on {smi}")
        print(f"   sample_grids ({TRAINER_SAMPLE_N} images, {TRAINER_SAMPLING_STEPS} steps, clean + backdoor with "
              f"movie): median {statistics.median(grid_s):.2f} s a call over {len(grid_s)} calls, "
              f"{statistics.median(call_s) / TRAINER_SAMPLING_STEPS * 1e3:.3f} ms/step a chain; on {smi}")
        print(f"   sync save_trainer_state ({state_gb:.3f} GB of parameters, mu, nu) {save_s:.2f} s; HF export "
              f"(save_pretrained) {export_s:.2f} s; on {smi}")

        # async: a train step runs before the write is finished; the read-back holds the saved bits
        async_dir = os.path.join(run_dir, "async")
        at_save = {k: v.clone() if torch.is_tensor(v) else v for k, v in state_tensors(state2).items()}
        t0 = time.perf_counter()
        save_checkpoint(async_dir, state2, TRAINER_RESUME_EPOCHS - 1, make_pipeline2, async_save=True)
        async_s = time.perf_counter() - t0
        image, is_clean = (torch.from_numpy(a).to(dev) for a in train_batch(np.random.RandomState(5), BATCH))
        step2(state2, image, is_clean, torch.Generator(dev).manual_seed(6))
        t0 = time.perf_counter()
        finish_async_saves()
        finish_s = time.perf_counter() - t0
        check(read_json(os.path.join(async_dir, "data.json"))["ckpt"] == "ckpt.v0", "trainer: async data.json")
        _, _, _ = load_trainer_state(async_dir, state)
        check_same_state("trainer: async save read back vs the state at the save", state_tensors(state), at_save)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"   async save_checkpoint returned in {async_s:.2f} s (host copy and HF export), finished "
              f"{finish_s:.2f} s after a train step; read back bitwise equal to the state at the save")
        print(f"   peak device memory over the phase {peak:.1f} GiB; the phase took "
              f"{time.perf_counter() - phase_t0:.1f} s; on {smi}")
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
        if not os.listdir(TMP_BASE):
            os.rmdir(TMP_BASE)
    counts = {k: counts1[k] + counts2[k] for k in counts1}
    return end1 + steps2, sampled1 + sampled2, counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test runs only on a GPU", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    smi = phase_environment()
    gen = torch.Generator(dev).manual_seed(0)
    kernels = [phase_groupnorm(dev, gen), phase_groupnorm_backward(dev, gen), phase_attention(dev, gen)]
    forwards, sampling = phase_slice(dev, smi)
    zoo_fwd, zoo = phase_zoo(dev, smi)
    steps, training, bare_ms = phase_train(dev, smi)
    loop_steps, loop_sampled, trainer_counts = phase_trainer(dev, smi, bare_ms)

    for path, n, counts, want in (
        ("sampling", f"{forwards} UNet forwards", sampling,
         {"groupnorm_silu": GN_PER_FORWARD * forwards, "groupnorm_silu_backward": 0,
          "attention": ATTN_PER_FORWARD * forwards}),
        ("sampler zoo", f"{zoo_fwd} UNet forwards", zoo,
         {"groupnorm_silu": GN_PER_FORWARD * zoo_fwd, "groupnorm_silu_backward": 0,
          "attention": ATTN_PER_FORWARD * zoo_fwd}),
        ("training", f"{steps} train steps", training,
         {"groupnorm_silu": GN_PER_FORWARD * steps, "groupnorm_silu_backward": GN_PER_FORWARD * steps,
          "attention": ATTN_PER_FORWARD * steps}),
        ("trainer", f"{loop_steps} train steps and {loop_sampled} sampling forwards", trainer_counts,
         {"groupnorm_silu": GN_PER_FORWARD * (loop_steps + loop_sampled),
          "groupnorm_silu_backward": GN_PER_FORWARD * loop_steps,
          "attention": ATTN_PER_FORWARD * (loop_steps + loop_sampled)}),
    ):
        print(f"launch counts over the {path} path ({n} on the card): "
              + ", ".join(f"{k}={v}" for k, v in counts.items()))
        check(counts == want and counts["groupnorm_silu"] > 0, f"{path} launches {counts}, want {want}")
    for k in kernels:
        k["launches"] = sampling[k["name"]] + zoo[k["name"]] + training[k["name"]] + trainer_counts[k["name"]]
    print(f"chip_smoke: every check passed in {time.perf_counter() - t0:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
