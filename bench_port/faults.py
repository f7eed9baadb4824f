"""Faults planted in the program, which the comparison that decides a cell's
``correct`` must catch: each runs the cell through the harness, as a run
does, with one fault patched into the port for the whole process.

    python3 -m bench_port.faults --workload ldm-celebahq-256.measure --seeds 1 2 [--faults NAME ...] \\
        [--seconds 1] [--out FILE]

Prints one JSON line a fault and seed (and appends it to ``--out``): the
compared numbers beside their limits and whether the run read correct.
The CPU tests (``bench_port/tests/test_bench_port_ldm.py``) plant the same
faults at small sizes.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from unittest import mock

from bench_port import harness
from bench_port.run import ROOT, _fix_environment, _json_safe


@contextlib.contextmanager
def row_unstepped():
    """Row 0 of every DDIM step left where it was."""
    from baddiffusion_tpu_torch.schedulers.ddim import DDIMScheduler

    original = DDIMScheduler.step

    def step(self, state, model_output, step_index, sample, noise=None):
        state, prev, x0 = original(self, state, model_output, step_index, sample, noise)
        prev = prev.clone()
        prev[0] = sample[0]
        return state, prev, x0

    with mock.patch.object(DDIMScheduler, "step", step):
        yield


def _quantizer_fault(swap_code: bool):
    """The quantizer's first vector given the next code's row; with
    ``swap_code`` its code too, else the code is left right."""
    from baddiffusion_tpu_torch.models import vae

    original = vae.vq_nearest

    def vq_nearest(z, codebook):
        idx, z_q = original(z, codebook)
        idx, z_q = idx.clone(), z_q.clone()
        wrong = (idx[0] + 1) % codebook.shape[0]
        z_q[0] = codebook[wrong]
        if swap_code:
            idx[0] = wrong
        return idx, z_q

    return mock.patch.object(vae, "vq_nearest", vq_nearest)


@contextlib.contextmanager
def code_swapped():
    """The first vector's code and its row both the next code's."""
    with _quantizer_fault(swap_code=True):
        yield


@contextlib.contextmanager
def zq_row_wrong():
    """The first vector's quantized row the next code's, its code right."""
    with _quantizer_fault(swap_code=False):
        yield


@contextlib.contextmanager
def image_altered():
    """Row 0 of the decoded image moved by 0.05."""
    from baddiffusion_tpu_torch.models.vae import Decoder

    original = Decoder.forward

    def forward(self, z):
        out = original(self, z).clone()
        out[0] += 0.05
        return out

    with mock.patch.object(Decoder, "forward", forward):
        yield


FAULTS = {"row_unstepped": row_unstepped, "code_swapped": code_swapped, "zq_row_wrong": zq_row_wrong,
          "image_altered": image_altered}


def main(argv=None) -> int:
    _fix_environment()
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--faults", nargs="+", choices=sorted(FAULTS), default=sorted(FAULTS))
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)

    import torch

    cell = harness.resolve(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        for name in args.faults:
            with FAULTS[name]():
                result = harness.run_cell(ROOT, args.workload, seed, args.seconds, False, device, time.time())
            line = json.dumps(_json_safe({"fault": name, "seed": seed, "correct": result["correct"],
                                          "checks": result["checks"]}))
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
