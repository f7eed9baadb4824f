"""Sampling traffic: back-to-back 1000-step chains through
``DiffusionPipeline.__call__``, each batch half clean rows (from noise) and
half backdoor rows (from noise + trigger).

Set-up builds the UNet at the published widths (parameters f32, computing in
the mix's dtype, as the trainer's grids sample), loads the benchmark's
seeded weights, builds the DDPM scheduler and the pipeline, with the mix's
``segment_steps`` (0: the eager chain, whatever the program's default), takes
the trigger from the program's ``Backdoor`` and runs a few chain steps to
warm up every shape. The benchmark draws each chain's initial noise, and
hands the pipeline a generator seeded from (seed, chain) for its per-step
noise, as the command line does.

A hook on the UNet (a forward pre-hook and a forward hook, the benchmark's
own) counts an eager chain's steps, ends the window at the first step that
starts after its time ran out (after a synchronise, so that every counted
step has finished), and copies to pinned host memory the first chain's state
at step 0 and, every ``snapshot_every`` steps from an offset drawn from the
seed, a step's input x_k, its ε-prediction and the next step's input
x_{k+1}. Where no hook fires between a chain's steps (a chain replayed as
CUDA graphs), a chain counts whole when it returns, and the window ends at
the first chain's end after the time ran out; such a chain leaves no
snapshot, so its comparison reads nothing and the run is not correct.
``sample_imgs_per_s`` counts rows × steps done over the chain length and the
window's seconds, so a chain cut by the window counts the steps it made.

The comparison (after the window, with the program freed) checks the start
(x at step 0 against the benchmark's noise plus the reference's own
trigger on the backdoor rows, exactly), and, at every snapshot step the
window completed, the program's ε-prediction against the reference UNet's
in f32 on the same x_k, and the program's x_{k+1} against the reference step
from x_k with the reference's ε and the step's noise, replayed from the
chain's generator as DDPM draws it (one draw of the batch's shape a step, on
every step but the last), as the ε the program's step applied: the gap over
the step's coefficient on ε, over ‖ε‖ (the mix runs without the clip, so the
step is linear in ε), on the rows where ε's term is at least
``STEP_CONDITION`` of x_{k+1}'s norm. Measured against x_{k+1} − x_k, or
against the step's x₀ term, the gap swung by a factor of a hundred from seed
to seed with the step's t, and the control read under the program. The
reference follows the chain step by step from the program's own states; 1000
steps of two implementations part ways by rounding alone, so the whole chain
is not compared.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bench_port import trace
from bench_port.common import (DTYPES, TraceContext, WindowClosed, WindowResult, full_f32, generator, load_weights,
                               subseed, sync)
from bench_port.reference import unet as ref_unet
from bench_port.reference.diffusion import Schedule, box_trigger
from bench_port.reference.precision import BELOW, Precision
from bench_port.work.model import sites

MODE = "sample"
# a step is compared where ε moves x_{k+1} by at least this share of its norm: below it, f32's rounding of
# x_{k+1} (a few parts in 1e7) would read as a gap of ε over a tenth of the limits. A chain from seeded,
# untrained weights grows (root mean square ~270 by step 999 at 32 px), so only its first ~200 steps qualify.
STEP_CONDITION = 1e-3
WARM_CHAIN, TRACE_CHAIN = 1 << 20, 1 << 21  # chain indices of the set-up's and the trace's chains


class _Probe:
    """The benchmark's hooks on the UNet: step counting, the window's end,
    snapshots and the trace's spans."""

    def __init__(self, module: torch.nn.Module, device: torch.device):
        self.device = device
        self.step = 0
        self.deadline: Optional[float] = None
        self.limit: Optional[int] = None
        self.closed_at: Optional[float] = None
        self.snaps: Dict[int, Dict[str, torch.Tensor]] = {}
        self.spans = False
        self._span = None
        self._handles = [module.register_forward_pre_hook(self._pre), module.register_forward_hook(self._post)]

    def arm(self, deadline=None, limit=None, snaps=None, spans=False):
        self.step, self.deadline, self.limit, self.closed_at = 0, deadline, limit, None
        self.snaps = snaps or {}
        self.spans = spans

    def _keep(self, k: int, key: str, t: torch.Tensor) -> None:
        slot = self.snaps.get(k)
        if slot is not None and key in slot:
            slot[key].copy_(t.detach(), non_blocking=True)
            slot["have_" + key] = True

    def _pre(self, module, args):
        i = self.step
        if (self.deadline is not None and time.perf_counter() >= self.deadline) or \
                (self.limit is not None and i >= self.limit):
            sync(self.device)
            self.closed_at = time.perf_counter()
            raise WindowClosed()
        if self.snaps:
            self._keep(i, "x", args[0])
            self._keep(i - 1, "x_next", args[0])
        if self.spans:
            self._span = torch.profiler.record_function("bench.unet")
            self._span.__enter__()

    def _post(self, module, args, out):
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None
        if self.snaps:
            self._keep(self.step, "eps", out)
        self.step += 1

    def close(self):
        for h in self._handles:
            h.remove()


class Session:
    def __init__(self, cell, seed: int, device: torch.device, root: str):
        from baddiffusion_tpu_torch.data.triggers import Backdoor
        from baddiffusion_tpu_torch.models.unet2d import UNet2DConfig, UNet2DModel
        from baddiffusion_tpu_torch.pipelines import DiffusionPipeline
        from baddiffusion_tpu_torch.schedulers import DDPMConfig, DDPMScheduler

        self.seed, self.device, self.root = seed, device, root
        tr = self.traffic = cell.traffic
        self.cfg = cell.unet
        self.dtype = tr["dtype"]
        self.size, self.channels = self.cfg["sample_size"], self.cfg["in_channels"]
        self.batch, self.clean_rows = tr["batch"], tr["clean_rows"]
        self.steps = tr["chain_steps"]
        self.shape = (self.batch, self.size, self.size, self.channels)
        torch.backends.cuda.matmul.allow_tf32 = bool(tr.get("matmul_tf32", False))
        torch.backends.cudnn.allow_tf32 = bool(tr.get("cudnn_tf32", True))

        model = UNet2DModel(UNet2DConfig(**self.cfg), device=device, dtype=DTYPES[self.dtype])
        weights = ref_unet.init_params(self.cfg, generator(device, seed, 1), device)
        load_weights(model, weights)
        self.w0 = {n: v.cpu() for n, v in weights.items()}
        del weights
        self.scheduler = DDPMScheduler(DDPMConfig(num_train_timesteps=1000, clip_sample=tr["clip_sample"]))
        self.pipe = DiffusionPipeline(model, self.scheduler, device=device)
        self.pipe.segment_steps = tr["segment_steps"]
        trig = Backdoor().get_trigger(tr["trigger"], channel=self.channels, image_size=self.size)
        self.trigger = torch.tensor(trig, device=device)
        self.probe = _Probe(self.pipe.unet, device)
        self.snaps = self._snap_buffers()
        self._ref = {}  # (step, first row) -> the f32 reference's ε and next x
        self._chain(WARM_CHAIN, limit=tr["warm_steps"])
        sync(device)

    def _snap_buffers(self) -> Dict[int, Dict[str, torch.Tensor]]:
        """Host buffers (pinned on the card) for the first chain's snapshots:
        x at step 0, and x, ε and the next x at every
        ``snapshot_every``-th step from a seeded offset."""
        every = self.traffic["snapshot_every"]
        offset = int(np.random.default_rng(subseed(self.seed, 7)).integers(0, every))
        pin = self.device.type == "cuda"
        buf = lambda: torch.empty(self.shape, dtype=torch.float32, pin_memory=pin)
        snaps = {0: {"x": buf()}}
        for k in range(offset, self.steps - 1, every):
            slot = snaps.setdefault(k, {})
            slot.update({key: buf() for key in ("x", "eps", "x_next")})
        return snaps

    def _init(self, chain: int):
        noise = torch.randn(self.shape, generator=generator(self.device, self.seed, 5, chain), device=self.device)
        init = noise.clone()
        init[self.clean_rows:] += self.trigger
        return noise, init

    def _chain(self, chain: int, deadline=None, limit=None, snaps=None, spans=False):
        """One pipeline call; returns (steps done, whether the window closed):
        the hook's count where it closed the window inside the chain, else
        the whole chain."""
        _, init = self._init(chain)
        self.probe.arm(deadline, limit, snaps, spans)
        try:
            self.pipe(batch_size=self.batch, generator=generator(self.device, self.seed, 6, chain), init=init,
                      num_inference_steps=self.steps, output_type="pt")
        except WindowClosed:
            return self.probe.step, True
        sync(self.device)
        self.probe.closed_at = time.perf_counter()
        return self.steps, deadline is not None and self.probe.closed_at >= deadline

    def _noise(self, ks: List[int]) -> Dict[int, torch.Tensor]:
        """The first chain's noise at steps ``ks``, replayed from its
        generator: one draw of the batch's shape a step before the last."""
        draws = generator(self.device, self.seed, 6, 0)
        out = {}
        for k in range(max(ks) + 1 if ks else 0):
            z = torch.randn(self.shape, generator=draws, device=self.device)
            if k in ks:
                out[k] = z
        return out

    def window(self, seconds: float) -> WindowResult:
        sync(self.device)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        done, chain = 0, 0
        while True:
            steps, closed = self._chain(chain, deadline=deadline, snaps=self.snaps if chain == 0 else None)
            done += steps
            chain += 1
            if closed:
                break
        elapsed = self.probe.closed_at - t0
        rate = self.batch * done / elapsed  # image-steps a second
        return WindowResult(metrics={"sample_imgs_per_s": rate / self.steps}, attempted=done, failed=0, rate=rate)

    def traced(self, rate: float) -> TraceContext:
        from baddiffusion_tpu_torch import ops

        steps = self.traffic["trace_steps"]
        before = ops.launch_counts()
        tl = trace.profile(lambda: self._chain(TRACE_CHAIN, limit=steps, spans=True), lambda: sync(self.device),
                           self.device.type == "cuda")
        after = ops.launch_counts()
        s = sites(self.cfg, self.size)
        return TraceContext(timeline=tl, mode=MODE, dtype=self.dtype, sites=s, steps=steps, rows=self.batch,
                            micro=self.batch, calls=1, rate=rate,
                            launches={k: after[k] - before[k] for k in after}, flops_per_row=s.product_flops,
                            save_stats=False)

    def release(self) -> None:
        self.probe.close()
        del self.pipe, self.probe
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _compared(self) -> List[int]:
        """Every snapshot step of the first chain whose x_k, ε and next x all
        arrived before the window closed."""
        return sorted(k for k, s in self.snaps.items() if s.get("have_x_next") and s.get("have_eps"))

    def check(self, control: Optional[str] = None) -> Dict[str, float]:
        """The compared numbers: the program's (``control`` None) or, put in
        its place, the reference one precision lower (``"lower"``)."""
        dev, tr = self.device, self.traffic
        params = {n: v.to(dev) for n, v in self.w0.items()}
        schedule = Schedule(dev)
        ratio = 1000 // self.steps
        rows = tr["reference_rows"]
        trig = torch.tensor(box_trigger(tr["trigger"], self.size, self.channels))
        expected = self._init(0)[0].cpu()
        expected[self.clean_rows:] += trig
        init_gap = float((self.snaps[0]["x"] - expected).abs().max()) if self.snaps[0].get("have_x") else float("inf")
        ks = self._compared()
        noise = self._noise(ks)
        eps_gap = float("inf") if not ks else 0.0
        step_gap = float("inf")  # until a well-conditioned row is compared
        prec = None if control is None else Precision(BELOW[self.dtype])
        if control not in (None, "lower"):
            raise ValueError(f"control {control!r}")
        with full_f32(), torch.no_grad():
            for k in ks:
                s = self.snaps[k]
                t = (self.steps - 1 - k) * ratio
                for r0 in range(0, self.batch, rows):
                    sl = slice(r0, r0 + rows)
                    x, z = s["x"][sl].to(dev), noise[k][sl]
                    tt = torch.full((x.shape[0],), t, device=dev, dtype=torch.long)
                    if (k, r0) not in self._ref:
                        eps_ref = ref_unet.forward(params, self.cfg, x, tt)
                        nxt_ref, eps_coef = schedule.ddpm_step(x, eps_ref, t, t - ratio, z, tr["clip_sample"])
                        self._ref[(k, r0)] = (eps_ref.cpu(), nxt_ref.cpu(), eps_coef)
                    eps_ref, nxt_ref, eps_coef = self._ref[(k, r0)]
                    eps_ref, nxt_ref = eps_ref.to(dev), nxt_ref.to(dev)
                    if control is None:
                        eps, nxt = s["eps"][sl].to(dev), s["x_next"][sl].to(dev)
                    else:
                        eps = ref_unet.forward(params, self.cfg, x, tt, prec)
                        nxt = schedule.ddpm_step(x, eps, t, t - ratio, z, tr["clip_sample"])[0]
                    dims = (1, 2, 3)
                    eg = torch.linalg.vector_norm(eps - eps_ref, dim=dims) / torch.linalg.vector_norm(eps_ref, dim=dims)
                    # x and the noise enter both sides alike: the result's gap over k is the gap between
                    # the ε the step applied and the reference's ε (or a step not taken)
                    moved = eps_coef * torch.linalg.vector_norm(eps_ref, dim=dims)
                    sg = torch.linalg.vector_norm(nxt - nxt_ref, dim=dims) / moved
                    eps_gap = max(eps_gap, float(eg.max()))
                    sound = moved >= STEP_CONDITION * torch.linalg.vector_norm(nxt_ref, dim=dims)
                    if bool(sound.any()):
                        step_gap = max(0.0 if step_gap == float("inf") else step_gap, float(sg[sound].max()))
        return {"init_gap": init_gap, "eps_gap": eps_gap, "step_gap": step_gap}
