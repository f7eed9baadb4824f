#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Environment: the card's name and power limit, torch and CUDA versions,
   the kernels' build time (nvcc, from the sources in the checkout). TF32 is
   off for cuDNN and cuBLAS so the f32 checks compare full f32.
2. Kernels against their plain PyTorch versions on the card, at every shape
   the main path gives them (batch 128), in bf16 and f32, with the device
   time (torch.profiler) of the kernel, the plain version and one PyTorch
   library call, and the least time the card could take (bytes over
   3.35 TB/s or operations over peak).
3. The main path: the full-width scratch UNet (113.7M parameters, 32 px) with
   seeded weights, saved and reloaded through the pipeline's HF layout, one
   f32 forward and a 10-step f32 chain checked against the CPU's plain path,
   then 1000-step bf16 DDPM sampling from noise and from noise + trigger
   (BOX_14); then where the time goes: a profiled 20-step bf16 chain and
   timed bf16 forwards at batch 16 and 128, split by layer.
4. Launch counts over the main path's run (the sampling chains of phase 3,
   counters set to 0 just before them): every GroupNorm+SiLU and attention
   call must have gone through its kernel (65 and 6 per UNet forward).

The last line is {"ok": true, "device": {...}}; the line before it lists every
kernel with its numbers. Any failed check raises, and the script exits
non-zero. Without CUDA it exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import os
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

from baddiffusion_tpu_torch import ops
from baddiffusion_tpu_torch.data import Backdoor
from baddiffusion_tpu_torch.models import DEFAULT_SCRATCH_CONFIG, UNet2DModel
from baddiffusion_tpu_torch.ops import _build
from baddiffusion_tpu_torch.pipelines import DiffusionPipeline
from baddiffusion_tpu_torch.schedulers import DDPMConfig, DDPMScheduler

ROOT = os.path.dirname(os.path.abspath(__file__))
TMP_BASE = os.path.join(ROOT, ".chip_smoke_tmp")

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

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
# attention [B, H, T, D] -> calls per forward (0: envelope shapes, checked only)
ATTN_SHAPES = {(BATCH, 64, 4, 8): 5, (BATCH, 64, 1, 8): 1, (16, 1, 256, 256): 0, (4, 8, 1024, 64): 0}
GN_PER_FORWARD = sum(GN_SHAPES.values())
ATTN_PER_FORWARD = sum(ATTN_SHAPES.values())
TOL = {torch.float32: dict(atol=1e-5, rtol=0.0), torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}

SAMPLE_BATCH = 16
SAMPLE_STEPS = 1000
PROFILE_STEPS = 20
PROFILE_ATTEMPTS = 3
# kernel-name fragments -> the layer they belong to, for the device-time breakdown
KERNEL_GROUPS = (
    ("groupnorm_silu (K1)", ("groupnorm_silu_fwd_kernel",)),
    ("attention (K3)", ("attention_fwd_kernel",)),
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
    events at all (rarely: about one session in 200); the window is then
    measured again, at most ``PROFILE_ATTEMPTS`` times in all."""
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
            break
        print(f"   (profiler session {attempt} recorded no device events; measuring again)")
    check(bool(kernels), f"the profiler recorded no device time in {PROFILE_ATTEMPTS} sessions")
    host = {e.key: e.self_cpu_time_total / 1e3 / reps for e in events if e.device_type == DeviceType.CPU}
    return wall * 1e3 / reps, sum(kernels.values()), kernels, host


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


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


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
    the main path's calls per UNet forward, the bf16 device times and the
    bound's bytes and operations."""

    def __init__(self, name: str, source: str, replaces: str, library: str):
        self.entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces}
        self.library = library
        self.err = 0.0
        self.tot = dict(ms=0.0, wall_ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0)

    def shape(self, label: str, mult: int, dtype, kernel, plain, library, n_bytes: float, n_ops: float) -> None:
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        e = max_err(got, want)
        self.err = max(self.err, e)
        check(torch.allclose(got.float(), want.float(), **TOL[dtype]),
              f"{self.entry['name']} {label} {dtype}: max |kernel - plain| = {e:.3g}")
        if dtype != torch.bfloat16:  # time the main path's dtype only
            return
        k_ms, k_wall, p_ms, l_ms = device_ms(kernel), time_ms(kernel), device_ms(plain), device_ms(library)
        b_ms, b_by = bound_ms(n_bytes, n_ops, dtype)
        print(f"   {label} x{mult:2d}  bf16 kernel {k_ms:.4f} ms (per-call wall {k_wall:.4f})  plain {p_ms:.4f} ms  "
              f"{self.library} {l_ms:.4f} ms  bound {b_ms:.5f} ms ({b_by})  max err {e:.3g}")
        for key, val in (("ms", k_ms), ("wall_ms", k_wall), ("plain_ms", p_ms), ("library_ms", l_ms),
                         ("bytes", n_bytes), ("ops", n_ops)):
            self.tot[key] += mult * val

    def summary(self, calls: int) -> dict:
        tot = self.tot
        b_ms, b_by = bound_ms(tot["bytes"], tot["ops"], torch.bfloat16)
        print(f"   per UNet forward (B={BATCH}, bf16, {calls} calls): kernel {tot['ms']:.4f} ms "
              f"(per-call wall {tot['wall_ms']:.4f})  plain {tot['plain_ms']:.4f} ms  {self.library} "
              f"{tot['library_ms']:.4f} ms  bound {b_ms:.5f} ms ({tot['bytes'] / 1e9:.3f} GB)")
        return dict(self.entry, max_abs_err=self.err, ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=b_ms,
                    bound_by=b_by, library_ms=tot["library_ms"])


def phase_groupnorm(dev, gen) -> dict:
    print(f"-- K1 groupnorm_silu vs groupnorm_silu_plain, B={BATCH}, G={GROUPS}, eps={EPS}; "
          "tolerance f32 atol 1e-5 (sums reordered), bf16 atol 1e-2 rtol 1e-2 in f32 (one bf16 ulp ~0.8%)")
    rec = KernelRecord("groupnorm_silu", "baddiffusion_tpu_torch/csrc/groupnorm_silu.cu",
                       "baddiffusion_tpu/ops/groupnorm.py:135", "F.group_norm+F.silu")
    for (h, w, c), mult in GN_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(BATCH, h, w, c, generator=gen, device=dev).to(dtype)
            weight = (torch.rand(c, generator=gen, device=dev) + 0.5).to(dtype)
            bias = (0.1 * torch.randn(c, generator=gen, device=dev)).to(dtype)
            x_nchw = x.permute(0, 3, 1, 2)  # channels_last NCHW view for the library call
            rec.shape(
                f"({h:2d},{w:2d},{c:4d})", mult, dtype,
                lambda: ops.groupnorm_silu(x, weight, bias, GROUPS, EPS),
                lambda: ops.groupnorm_silu_plain(x, weight, bias, GROUPS, EPS),
                lambda: F.silu(F.group_norm(x_nchw, GROUPS, weight, bias, EPS)),
                n_bytes=2 * x.numel() * x.element_size() + 2 * c * x.element_size(),
                n_ops=GN_FLOPS_PER_ELEMENT * x.numel(),
            )
    return rec.summary(GN_PER_FORWARD)


def phase_attention(dev, gen) -> dict:
    print("-- K3 attention vs attention_plain; tolerance f32 atol 1e-5 (sums reordered), "
          "bf16 atol 1e-2 rtol 1e-2 in f32")
    rec = KernelRecord("attention", "baddiffusion_tpu_torch/csrc/attention.cu",
                       "baddiffusion_tpu/ops/attention.py:42", "sdpa")
    for (b, h, t, d), mult in ATTN_SHAPES.items():
        scale = 1.0 / d**0.5
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(b, h, t, d, generator=gen, device=dev).to(dtype) for _ in range(3))
            rec.shape(
                f"[{b},{h},{t},{d}]", mult, dtype,
                lambda: ops.attention(q, k, v, scale),
                lambda: ops.attention_plain(q, k, v, scale),
                lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                n_bytes=4 * q.numel() * q.element_size(),
                n_ops=4 * b * h * t * t * d + 5 * b * h * t * t,  # q.k and p.v products, softmax
            )
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
    unet_bf16 = copy.deepcopy(pipe.unet).to(torch.bfloat16)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test runs only on a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = phase_environment()
    gen = torch.Generator(dev).manual_seed(0)
    kernels = [phase_groupnorm(dev, gen), phase_attention(dev, gen)]
    forwards, counts = phase_slice(dev, smi)

    print(f"launch counts over the main path ({forwards} UNet forwards on the card): "
          + ", ".join(f"{k}={v}" for k, v in counts.items()))
    check(forwards > 0, "no UNet forward ran on the card")
    check(counts["groupnorm_silu"] == GN_PER_FORWARD * forwards > 0,
          f"groupnorm_silu launched {counts['groupnorm_silu']} times, want {GN_PER_FORWARD} x {forwards}")
    check(counts["attention"] == ATTN_PER_FORWARD * forwards > 0,
          f"attention launched {counts['attention']} times, want {ATTN_PER_FORWARD} x {forwards}")
    for k in kernels:
        k["launches"] = counts[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
