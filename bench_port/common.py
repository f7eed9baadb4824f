"""Small pieces the generators share: dtypes, weights, seeds, clocks, the
device, the traced context the per-layer readers take."""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from bench_port.work.model import Sites


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def load_weights(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy the benchmark's weights into the program's parameters, name by
    name; the two name sets must be equal."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        missing, extra = sorted(set(weights) - set(params)), sorted(set(params) - set(weights))
        raise ValueError(f"parameter names differ from the published ones: missing {missing[:5]}, extra {extra[:5]}")
    names = list(params)
    with torch.no_grad():
        torch._foreach_copy_([params[n] for n in names], [weights[n] for n in names])


def subseed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of draws, a function of the run's seed
    (any whole number) and the tags alone."""
    hi, lo = np.random.SeedSequence([seed % (1 << 128), *tags]).generate_state(2, np.uint32)
    return (int(hi) << 31) | (int(lo) >> 1)


def generator(device: torch.device, seed: int, *tags: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(subseed(seed, *tags))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def process_start_time() -> float:
    """The wall time this process started, from ``/proc`` (10 ms ticks);
    the import time of this module where ``/proc`` is absent."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return _IMPORTED


_IMPORTED = time.time()


@dataclasses.dataclass
class TraceContext:
    """What a per-layer reader takes: the traced window's timeline, the
    cell's mode (``train`` or ``sample``), and the counts of the traced
    window. ``steps`` are optimizer steps or chain steps; ``rows`` the rows a
    step (samples or images); ``micro`` the rows of one UNet call and
    ``calls`` the UNet calls a step; ``rate`` the untraced window's samples
    or image-steps a second; ``launches`` the program's K1/K2/K3 launch
    counters over the traced steps."""

    timeline: object
    mode: str
    dtype: str
    sites: Sites
    steps: int
    rows: int
    micro: int
    calls: int
    rate: float
    launches: Dict[str, int]
    flops_per_row: float  # model FLOPs of one row's step (3 forwards training, 1 sampling)
    save_stats: bool = True


@dataclasses.dataclass
class WindowResult:
    metrics: Dict[str, float]
    attempted: int
    failed: int
    rate: float


class WindowClosed(Exception):
    """Raised from a chain's hook when the window's time is up."""


def finite(x: Optional[float]) -> bool:
    return x is not None and np.isfinite(x)


@contextlib.contextmanager
def full_f32():
    """cuDNN and cuBLAS in full f32 inside the block (the reference's
    precision), the process's settings restored after."""
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, matmul
