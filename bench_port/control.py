"""Read the comparison's two ends on the card: for each seed, one cell's
set-up and a short window as a run makes them, then the compared numbers of
the program, of the reference one precision below the cell's (the control),
and, for a training cell, of the reference over half of each block's rows
(a fault the comparison must catch). The limits in ``limits/<cell>.json``
are set from these readings and from the benchmark's own runs.

    python3 -m bench_port.control --workload <cell> --seeds 1 2 3 [--seconds 5] [--out FILE]

Prints one JSON line a seed (and appends it to ``--out``): each side's
numbers and whether they are within the cell's limits.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional

from bench_port import harness
from bench_port.run import ROOT, _fix_environment, _json_safe


def readings(root: str, name: str, seed: int, seconds: float, device, overrides: Optional[Dict] = None) -> Dict:
    """One seed's readings: a run's set-up and window, then the compared
    numbers of the program, of the control and, for a training cell, of the
    half-batch fault, each judged against the cell's limits."""
    cell = harness.resolve(root, name)
    if overrides:
        cell.traffic.update(overrides)
    gen = harness.generator_module(cell)
    session = gen.Session(cell, seed, device, root)
    session.window(seconds)
    session.release()
    row = {"cell": name, "seed": seed}
    for label in ("program", "lower") + (("half_batch",) if gen.MODE == "train" else ()):
        numbers = session.check(None if label == "program" else label)
        row[label] = numbers
        row[label + "_correct"] = harness.judge(numbers, cell.limits)[1]
    return row


def main(argv=None) -> int:
    _fix_environment()
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)

    import torch

    cell = harness.resolve(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        line = json.dumps(_json_safe(readings(ROOT, args.workload, seed, args.seconds, device)))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
