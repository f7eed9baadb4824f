"""Device time from a profiler trace (port of
``baddiffusion_tpu/utils/profiling.py``).

The JAX module reads the HBM bytes a traced window moved from the TPU's
xplane (``measure_hbm_traffic``, ``xplane_hbm_bytes``, ``hbm_top_ops``). On
the GPU the counters that would give a byte count are read by Nsight Compute
and Nsight Systems, which the card's machine cannot run; torch.profiler
(CUPTI) records each kernel's start and end but no bytes. So this module
measures device time:

- ``device_profile(fn, reps)``: ``fn`` run ``reps`` times under
  torch.profiler after one warm-up call; each kernel's device time a call and
  each host op's self time a call.
- ``measure_device_time(run_once, steps)``: device ms a step, wall ms a step,
  the device's idle share and the split by kernel class (``KERNEL_CLASSES``:
  K1, K2, K3, conv, matmul, other), with the JAX module's ``hbm_*`` fields
  present and ``None``.
- ``top_device_ops(stats, k, by="time")``: the counterpart of
  ``hbm_top_ops``, by time.

On the card a profiler session now and then comes back with no device
events at all (about one session in 200, at times several in a row);
``device_profile`` then profiles the window again, at most
``PROFILE_ATTEMPTS`` times, and after that times it with CUDA events, under
the one kernel name ``EVENT_TIMED`` (launch gaps included, no host ops).

With ``device="cpu"`` the window runs under the CPU profiler: the "device"
is the host, each aten op's self time stands where a kernel's would, and the
result names the device ``"cpu"``. Its numbers are host times, never the
card's.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, List, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from baddiffusion_tpu_torch.device import DeviceLike, resolve_device

__all__ = [
    "EVENT_TIMED",
    "KERNEL_CLASSES",
    "PROFILE_ATTEMPTS",
    "device_profile",
    "device_time_by_class",
    "format_by_class",
    "kernel_class",
    "measure_device_time",
    "time_ms",
    "top_device_ops",
]

PROFILE_ATTEMPTS = 3
EVENT_TIMED = "(whole window, CUDA events)"  # device_profile's one entry when the profiler recorded nothing
# kernel-name fragments (lower case) -> the class a kernel belongs to; a name
# no class claims is "other" (elementwise kernels, copies, cat, plain norms)
KERNEL_CLASSES = (
    ("K1", ("groupnorm_silu_fwd_kernel",)),
    ("K2", ("groupnorm_silu_bwd_kernel", "sum_rows_kernel")),
    ("K3", ("attention_packed_kernel", "attention_tiled_kernel", "attention_rowwise_kernel")),
    ("conv", ("fprop", "conv", "cutlass", "implicit_gemm", "xmma")),
    ("matmul", ("nvjet", "gemm", "cublas", "aten::mm", "aten::addmm", "aten::bmm")),
)
OTHER = "other"


def time_ms(fn: Callable[[], object], reps: int = 20, repeats: int = 5) -> float:
    """Median over ``repeats`` of the CUDA-event time of ``reps`` back-to-back
    calls, per call, after one warm-up call: the wall time a caller pays,
    launch overhead included. Needs the card."""
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


def device_profile(fn: Callable[[], object], reps: int = 20, device: DeviceLike = None
                   ) -> Tuple[float, float, Dict[str, float], Dict[str, float]]:
    """``fn`` run ``reps`` times under torch.profiler after one warm-up call,
    on ``device`` (CUDA unless the caller asks otherwise). Returns (host wall
    ms a call, device kernel ms a call, {kernel name: device ms a call},
    {host op: self host ms a call}). The device time is the sum of the
    kernels' own durations, free of launch gaps; host op times include the
    profiler's own cost. On the CPU the kernels are the aten ops' self
    times and the host ops the same."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fn()
    sync()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            sync()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        host = {e.key: e.self_cpu_time_total / 1e3 / reps for e in events
                if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0}
        if not cuda:
            return wall * 1e3 / reps, sum(host.values()), dict(host), host
        kernels = {e.key: e.self_device_time_total / 1e3 / reps for e in events
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
        if kernels:
            return wall * 1e3 / reps, sum(kernels.values()), kernels, host
        print(f"   (profiler session {attempt} recorded no device events; measuring again)")
    ms = time_ms(fn, reps=reps, repeats=1)
    print(f"   (no device events in {PROFILE_ATTEMPTS} profiler sessions: this window timed with CUDA events, "
          "launch gaps included)")
    return ms, ms, {EVENT_TIMED: ms}, {}


def kernel_class(name: str) -> str:
    low = name.lower()
    return next((cls for cls, frags in KERNEL_CLASSES if any(f in low for f in frags)), OTHER)


def device_time_by_class(kernels: Dict[str, float]) -> Dict[str, float]:
    """{K1, K2, K3, conv, matmul, other: summed ms} of a ``{kernel: ms}`` map,
    every class present, in ``KERNEL_CLASSES`` order."""
    out = {cls: 0.0 for cls, _ in KERNEL_CLASSES}
    out[OTHER] = 0.0
    for name, ms in kernels.items():
        out[kernel_class(name)] += ms
    return out


def measure_device_time(run_once: Callable[[], object], steps: int = 4, device: DeviceLike = None) -> Dict:
    """Profile ``steps`` calls of ``run_once`` (after one warm-up call) and
    return, a step: ``device_time_ms_per_step`` (the kernels' own time),
    ``wall_ms_per_step``, ``idle_share`` (the share of the wall time with no
    kernel running), ``by_class`` (``device_time_by_class``) and ``kernels``
    ({name: ms}, what ``top_device_ops`` reads), with ``device`` naming the
    card (or ``"cpu"``: host times then).

    ``hbm_gib_per_step``, ``hbm_bytes_per_step``, ``hbm_gbps_busy`` and
    ``measured_flops_per_step`` keep the JAX module's names and are ``None``:
    torch.profiler records no bytes or operations, and the tools that read
    the card's counters (Nsight Compute, Nsight Systems) do not run where the
    card is. A bound in bytes is computed from the shapes instead."""
    dev = resolve_device(device)
    wall, dev_ms, kernels, _ = device_profile(run_once, reps=steps, device=dev)
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "device_time_ms_per_step": dev_ms,
        "wall_ms_per_step": wall,
        "idle_share": max(0.0, 1.0 - dev_ms / wall) if wall > 0 else 0.0,
        "by_class": device_time_by_class(kernels),
        "kernels": kernels,
        "steps": steps,
        "hbm_gib_per_step": None,
        "hbm_bytes_per_step": None,
        "hbm_gbps_busy": None,
        "measured_flops_per_step": None,
    }


def top_device_ops(stats: Dict, k: int = 25, by: str = "time") -> List[Tuple[str, str, float]]:
    """The ``k`` kernels of a ``measure_device_time`` result that took the
    most device time a step: rows of (kernel class, name, ms a step). Only
    ``by="time"`` is measured; ``by="bytes"`` (``hbm_top_ops``'s default)
    raises, since no byte count is."""
    if by != "time":
        raise ValueError(f"top_device_ops sorts by 'time' only (no byte count is measured on the card), got {by!r}")
    rows = sorted(stats["kernels"].items(), key=lambda kv: -kv[1])[:k]
    return [(kernel_class(name), name, ms) for name, ms in rows]


def format_by_class(by_class: Dict[str, float], per: float = 1.0) -> str:
    """``by_class`` as one line, ms over ``per`` and the share of the sum."""
    total = sum(by_class.values()) or 1.0
    return ", ".join(f"{cls} {ms / per:.4f} ms ({100 * ms / total:.1f}%)" for cls, ms in by_class.items())
