"""The traced window: torch.profiler (CUPTI) over a few steps, read back from
its Chrome trace into a ``Timeline`` that the per-layer readers share.

- ``busy_s``: the union of the device intervals (kernels, copies, memsets)
  inside the window, so work that overlaps on two streams counts once;
  ``window_s`` is the window span's length (from before the first step's
  enqueue to after the synchronise that ends it).
- ``kernel_seconds(match)``: summed durations of the kernels whose name
  contains one of the fragments.
- ``seconds_under(prefix)``: device seconds of the kernels launched while a
  host op whose name starts with ``prefix`` ran on the launching thread (the
  kernel's correlation id → its launch call → the ops enclosing that call).
- ``breakdown()``: the device operations that took most time, and the idle
  gaps summed by what the host was doing in them: the benchmark's span, and
  the innermost host op on the window's thread at the gap's middle.

Kernel classes are ``utils/profiling.py``'s, copied here so that the
yardstick stays with the benchmark.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

WINDOW_SPAN = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
KERNEL_CLASSES = {
    "K1": ("groupnorm_silu_fwd_kernel",),
    "K2": ("groupnorm_silu_bwd_kernel", "sum_rows_kernel"),
    "K3": ("attention_packed_kernel", "attention_tiled_kernel", "attention_tf32x3_kernel", "attention_wide_kernel"),
}
TOP = 10


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Timeline:
    """Device and host events of one traced window (times in µs)."""

    def __init__(self, events: List[Dict]):
        spans = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW_SPAN
                 and e.get("cat") == "user_annotation"]
        if not spans:
            raise ValueError(f"the trace holds no {WINDOW_SPAN!r} span")
        w = max(spans, key=lambda e: float(e["dur"]))
        self.start, self.end = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.thread = w.get("tid")
        self.device: List[Tuple[float, float, str, Optional[int]]] = []
        self.launch: Dict[int, Tuple[float, object]] = {}
        self.host: List[Tuple[float, float, str, object, str]] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                s, t = max(ts, self.start), min(ts + dur, self.end)
                if t > s:
                    self.device.append((s, t, e.get("name", ""), corr))
            elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                self.launch[corr] = (ts, e.get("tid"))
            elif cat in HOST_CATS and e.get("name") != WINDOW_SPAN:
                self.host.append((ts, ts + dur, e.get("name", ""), e.get("tid"), cat))
        self.busy = _union([(s, t) for s, t, _, _ in self.device])

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy) / 1e6

    def span_seconds(self, name: str) -> float:
        """Summed length of the host spans (``record_function``) called ``name``."""
        return sum(t - s for s, t, n, _, cat in self.host if n == name and cat == "user_annotation") / 1e6

    def kernel_seconds(self, fragments) -> float:
        return sum(t - s for s, t, name, _ in self.device if any(f in name for f in fragments)) / 1e6

    def class_seconds(self, cls: str) -> float:
        return self.kernel_seconds(KERNEL_CLASSES[cls])

    def seconds_under(self, prefix: str) -> float:
        """Device seconds of the kernels launched inside a host op whose name
        starts with ``prefix``."""
        by_thread: Dict[object, List[Tuple[float, float]]] = collections.defaultdict(list)
        for s, t, name, tid, _ in self.host:
            if name.startswith(prefix):
                by_thread[tid].append((s, t))
        merged = {tid: _union(v) for tid, v in by_thread.items()}
        starts = {tid: [s for s, _ in v] for tid, v in merged.items()}
        total = 0.0
        for s, t, _, corr in self.device:
            launch = self.launch.get(corr)
            if launch is None or launch[1] not in merged:
                continue
            ts, tid = launch
            i = bisect.bisect_right(starts[tid], ts) - 1
            if i >= 0 and merged[tid][i][1] >= ts:
                total += t - s
        return total / 1e6

    def idle_gaps(self) -> List[Tuple[float, float]]:
        gaps, cursor = [], self.start
        for s, t in self.busy:
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, t)
        if self.end > cursor:
            gaps.append((cursor, self.end))
        return gaps

    def _labeller(self) -> Callable[[float], str]:
        """A point in time -> the benchmark's span on the window's thread and
        the innermost host op running then: the window's thread's, else the
        latest-started one on another thread (the autograd engine's, during a
        backward)."""
        by_thread: Dict[object, List[Tuple[float, float, str]]] = collections.defaultdict(list)
        spans = []
        for s, t, name, tid, cat in self.host:
            by_thread[tid].append((s, t, name))
            if tid == self.thread and cat == "user_annotation" and name.startswith("bench."):
                spans.append((s, t, name))
        threads = {tid: (sorted(ops), [s for s, _, _ in sorted(ops)]) for tid, ops in by_thread.items()}
        spans.sort()
        span_starts = [s for s, _, _ in spans]

        def innermost(seq, seq_starts, p, limit):
            i = bisect.bisect_right(seq_starts, p) - 1
            for j in range(i, max(-1, i - limit), -1):
                if seq[j][1] >= p:
                    return seq[j]
            return None

        def label(p: float) -> str:
            span = innermost(spans, span_starts, p, 64)
            span = span[2] if span else WINDOW_SPAN
            found = {tid: innermost(ops, starts, p, 4096) for tid, (ops, starts) in threads.items()}
            op = found.get(self.thread)
            if op is None or op[2] == span:
                others = [o for tid, o in found.items() if o is not None and tid != self.thread]
                op = max(others, default=None)
            return span if op is None or op[2] == span else f"{span} > {op[2]}"

        return label

    def breakdown(self) -> Dict[str, List[List]]:
        ops: Dict[str, float] = collections.defaultdict(float)
        for s, t, name, _ in self.device:
            ops[name] += (t - s) / 1e6
        label = self._labeller()
        gaps: Dict[str, float] = collections.defaultdict(float)
        for s, t in self.idle_gaps():
            gaps[label((s + t) / 2.0)] += (t - s) / 1e6
        top = lambda d: [[k[:200], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def profile(run: Callable[[], None], sync: Callable[[], None], cuda: bool) -> Timeline:
    """``run`` under torch.profiler inside the window span, ended by ``sync``;
    the trace goes through a temporary file under TMPDIR, removed after."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            run()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Timeline(events)
