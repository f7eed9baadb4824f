"""The benchmark's driver: finds a cell's pieces by name, runs it, checks it,
prints the result.

Everything a cell needs is found from the names in ``BENCHMARK.json`` at the
checkout's root, so a new cell, configuration, traffic mix or per-layer
metric is new files and entries, never an edit here:

- the cell: its entry under ``workloads`` (config, traffic, chips);
- the configuration: the JSON file its entry under ``configs`` names
  (the published UNet keys under ``unet``);
- the traffic mix: ``bench_port/traffic/<traffic>.json``, parameters only;
  its ``generator`` names the code that drives it,
  ``bench_port/generators/<generator>.py``;
- the limits of the comparison: ``bench_port/limits/<cell>.json``;
- a per-layer metric: ``bench_port/metrics/<metric>.py``, whose
  ``read(ctx)`` returns its number or None.

A run: set-up (counted from the process's start to the window's start), the
measured window (``--seconds``), with ``--trace 1`` a traced window after it
and the per-layer metrics instead of the end-to-end ones, then, with the
program's state freed, the comparison with the reference. The result is the
last line of standard output; the compared numbers and their limits are also
the last lines of standard error.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "baddiffusion_tpu")
GIB = float(1 << 30)


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    chips: int
    limits: Dict[str, float]
    end_to_end: List[str]
    per_layer: List[str]
    units: Dict[str, str]

    @property
    def unet(self) -> Dict:
        return self.config["unet"]


def _load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: the cells it lists, or every
    cell where it lists none (a reader with nothing to read returns None)."""
    return cell in metric.get("workloads", [cell])


def resolve(root: str, name: str) -> Cell:
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    traffic = _load_json(os.path.join(root, "bench_port", "traffic", entry["traffic"] + ".json"))
    end_to_end = [m["name"] for m in bench["end_to_end"] if _reports(m, name)]
    per_layer = [m["name"] for m in bench["per_layer"] if _reports(m, name)]
    return Cell(name=name, config=_load_json(os.path.join(root, config["file"])), traffic=traffic,
                chips=int(entry["chips"]), limits=_load_json(os.path.join(root, "bench_port", "limits", name + ".json")),
                end_to_end=end_to_end, per_layer=per_layer,
                units={m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]})


def generator_module(cell: Cell):
    return importlib.import_module(f"bench_port.generators.{cell.traffic['generator']}")


def reader(root: str, metric: str):
    """The module of ``bench_port/metrics/<metric>.py`` (a metric's name may
    hold dots, so it is loaded by path)."""
    path = os.path.join(root, "bench_port", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_port_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared
    whole (``baddiffusion_tpu_torch`` is not ``baddiffusion_tpu``)."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[Dict[str, Dict], bool]:
    """Each compared number beside its limit, and whether all are within
    (a NaN never is); a number without a limit is read, not compared."""
    for k, v in numbers.items():
        if k not in limits:  # read, but no limit could hold it (PERF.md names it)
            print(f"reading {k}: {v!r} (not compared)", file=sys.stderr)
    checks = {k: {"value": float(numbers[k]), "limit": float(lim)} for k, lim in limits.items()}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool, device, started: float,
             overrides: Optional[Dict] = None) -> Dict:
    """One run of ``name``; returns the result line's object (``checks`` last).
    ``device`` is where the program runs; ``started`` the process's start
    (wall clock); ``overrides`` replace traffic parameters (the tests' small
    sizes)."""
    import torch

    cell = resolve(root, name)
    if overrides:
        cell.traffic.update(overrides)
    cuda = device.type == "cuda"
    gen = generator_module(cell)
    session = gen.Session(cell, seed, device, root)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - started
    win = session.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    metrics: Dict[str, Dict] = {}
    result: Dict = {"correct": False, "attempted": win.attempted, "failed": win.failed}
    if trace:
        ctx = session.traced(win.rate)
        for metric in cell.per_layer:
            value = reader(root, metric).read(ctx)
            if value is not None:
                metrics[metric] = {"value": float(value), "unit": cell.units[metric]}
        result["breakdown"] = ctx.timeline.breakdown()
        device_info = {"busy_s": ctx.timeline.busy_s, "window_s": ctx.timeline.window_s}
        print(f"launches over the traced steps: counted {ctx.launches}, from the shapes {expected_launches(ctx)}",
              file=sys.stderr)
    else:
        values = dict(win.metrics, setup_s=setup_s, peak_mem_gib=peak / GIB)
        for metric in cell.end_to_end:
            if metric in values:
                metrics[metric] = {"value": float(values[metric]), "unit": cell.units[metric]}
        device_info = {}
    session.release()
    checks, ok = judge(session.check(), cell.limits)
    result["correct"] = bool(ok and win.failed == 0)
    result["metrics"] = metrics
    result["device"] = dict(
        platform="gpu" if cuda else device.type,
        kind=torch.cuda.get_device_name(device) if cuda else device.type,
        count=1 if cuda else 0,
        memory_peak_bytes=int(peak),
        **device_info,
    )
    if trace and cuda:
        result["device"]["power_limit"] = power_limit()
    result["checks"] = checks
    return result


def expected_launches(ctx) -> Dict[str, int]:
    """K1, K2 and K3 calls of the traced steps as the shapes give them: the
    cross-check of the sites ``work/`` counts against the program's own
    launch counters."""
    calls = ctx.steps * ctx.calls
    return {"groupnorm_silu": len(ctx.sites.gn_silu) * calls,
            "groupnorm_silu_backward": len(ctx.sites.gn_silu) * calls if ctx.mode == "train" else 0,
            "attention": len(ctx.sites.attention) * calls}


def check_lines(checks: Dict[str, Dict]) -> List[str]:
    return [f"check {k}: {c['value']!r} limit {c['limit']!r} {'ok' if c['value'] <= c['limit'] else 'FAIL'}"
            for k, c in checks.items()]
