"""Segment mode: a chain run as segments of at most N steps (port of the JAX
package's ``DiffusionPipeline._segment_fns`` / ``_run_segmented``).

The JAX package compiles one N-step program and re-invokes it with the
carry (sample, scheduler state, key, frames) left on the device. Here
``sampler.Chain`` holds what every segment of a chain shares (the
scheduler's state after ``set_timesteps``, the timestep or σ table on the
device, the bounds of the movie) and runs a segment with
``sampler.chain_segment`` or ``sampler.sde_ve_segment``: on the CPU the
segments run eagerly one after another (``sample_chain``), the same
operations as the whole chain, so the same bits.

On the card a segment is a CUDA graph (``GraphedChain``): the chain's
segments are captured once, one graph per segment start, into one memory
pool, and replayed in capture order, each graph reading the carry the one
before it left at fixed addresses. A step's host control flow (the
timestep read with ``int(...)``, UniPC's float64 solves, the multistep
solvers' and PNDM's counters, which update a step computes) depends only on
its index and the configuration, never on device data (no chain step
synchronises), so a capture that freezes it is exact. This departs from the
JAX package, where one program serves every full-length segment and the
segment start is a traced scalar: making the index a device value in every
scheduler is left to later work. A capture that fails raises; there is no
eager stand-in on the card.
"""

from __future__ import annotations

import copy
import time
from typing import Callable, List

import torch

from baddiffusion_tpu_torch import ops
from baddiffusion_tpu_torch.pipelines.sampler import Chain
from baddiffusion_tpu_torch.utils.profiling import span

_capture_s: List[float] = []  # the seconds each chain captured in this process took, in order


def captures() -> List[float]:
    """The capture time of every ``GraphedChain`` captured since the last
    ``reset_captures``, in order: their count is the count of warm-up
    forwards the captures ran."""
    return list(_capture_s)


def reset_captures() -> None:
    _capture_s.clear()


def _counts_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


class GraphedChain:
    """A chain captured as CUDA graphs of at most ``segment_steps`` steps,
    for one input shape; ``__call__`` replays them.

    - ``model`` is a compute copy of the UNet that the graphs read; the
      caller refreshes it with ``copy_`` before each call, so weights
      updated in place are sampled.
    - The chain's noise comes from a generator the runner owns, registered
      with every graph: before the replays it takes the caller's state, and
      the caller's generator gets the advanced state after them, so a call
      draws what an eager chain draws from it and leaves it where an eager
      chain would. ``make_draw(generator)`` gives the chain's ``k -> noise``.
    - The input is copied into a fixed buffer; the result and movie are
      cloned out of the pool.
    - Before the first capture one UNet forward runs on the capture stream
      (the kernels' build and shared-memory opt-in, the cuDNN and cuBLAS
      handles and workspaces); it is a real forward and counts its launches.
    - ``ops.launch_counts()`` counts in Python, which sees only the capture:
      each graph's captured launches are taken off the counters after its
      capture and added back at each replay, so the counters still count
      executed launches.
    - Each segment's capture is the span ``graph.capture`` and each replay
      ``graph.replay`` (``utils/profiling.span``).
    """

    def __init__(self, chain: Chain, model, init_shape, segment_steps: int,
                 make_draw: Callable[[torch.Generator], Callable[[int], torch.Tensor]], device: torch.device):
        t0 = time.perf_counter()
        self.chain = chain
        self.static_init = torch.zeros(init_shape, device=device)
        self.generator = torch.Generator(device)
        self.stream = torch.cuda.Stream(device)
        draw = make_draw(self.generator)
        caller = torch.cuda.current_stream(device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            model(self.static_init, chain.table[chain.chain_start].expand(init_shape[0]))
        caller.wait_stream(self.stream)

        pool = torch.cuda.graph_pool_handle()
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.launches: List[dict] = []
        carry = None
        for s, length in chain.spans(segment_steps):
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(self.generator)
            before = ops.launch_counts()
            with span("graph.capture"), torch.cuda.graph(graph, pool=pool, stream=self.stream,
                                                        capture_error_mode="thread_local"):
                if carry is None:
                    carry = chain.start(self.static_init)
                carry = chain.run(carry, model, draw, s, length)
            captured = _counts_delta(before, ops.launch_counts())
            ops.add_launch_counts({k: -v for k, v in captured.items()})
            self.graphs.append(graph)
            self.launches.append(captured)
        self.carry = carry
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0
        _capture_s.append(self.capture_s)

    def __call__(self, init: torch.Tensor, generator: torch.Generator):
        self.static_init.copy_(init)
        self.generator.set_state(generator.get_state())
        for graph, launches in zip(self.graphs, self.launches):
            with span("graph.replay"):
                graph.replay()
            ops.add_launch_counts(launches)
        generator.set_state(self.generator.get_state())
        sample, frames = self.chain.result(self.carry)
        return sample.clone(), None if frames is None else frames.clone()


def compute_twin(unet, dtype: torch.dtype):
    """A copy of ``unet`` that computes in ``dtype``, for graphs to read:
    ``compute_copy`` when the dtype differs, else a plain deep copy."""
    twin = unet.compute_copy(dtype) if dtype != unet.dtype else copy.deepcopy(unet)
    return twin.requires_grad_(False)


def refresh_twin(twin, unet) -> None:
    """Copy ``unet``'s parameters and buffers into ``twin`` in place (cast to
    the twin's dtypes), so graphs that read the twin see the live weights."""
    for (name, dst), (src_name, src) in zip(twin.state_dict(keep_vars=True).items(),
                                            unet.state_dict(keep_vars=True).items()):
        if name != src_name or dst.shape != src.shape:
            raise ValueError(f"the graphs' copy has {name} {tuple(dst.shape)}, the UNet {src_name} {tuple(src.shape)}")
        dst.copy_(src)
