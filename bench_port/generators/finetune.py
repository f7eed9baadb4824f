"""Backdoor fine-tuning traffic: the program's train step fed as its trainer
feeds it.

Set-up draws ``dataset_size`` images from the seed (uniform bytes), writes
them as PPM files into the checkout's cache, and builds the program's
``DatasetLoader`` over that directory with the mix's trigger, target and
poison rate, ``device_prefetch`` over its batches, the UNet at the
configuration's published widths (parameters f32, computing in the mix's
dtype) holding the benchmark's seeded weights, the optimizer (clip and Adam
on a cosine warm-up schedule, the warm-up divided by the micro-batches as the
command line does) and ``make_train_step``. It then runs the window's own
step, ``checked_steps`` times, and keeps what the comparison reads: each
step's batch, loss and generator seed, the first gradient as Adam received
it (its first moment over 1 − β₁ after one update) and each parameter's
change after the checked steps. Two more steps warm up before the window.

A step (``_step``, the window's too) runs ``train_loop``'s body: the next
batch, the step's generator seeded from (seed, step), the step, and the loss
read every ``loss_every`` steps. The window ends after the step during which
the time ran out, at the synchronise that drains the queue.

The comparison (after the window, with the program's state freed) first
holds the feed to the benchmark's data: every row of the checked batches is
one of the benchmark's images or its mirror image (``rows_unknown``), each
row's clean flag is its record's (``flag_mismatch``), and the poisoned
records number ``poison_rate`` of the set (``poison_rows_gap``). It then runs
the plain f32 reference over the same weights and images, with its own
trigger, target and mask, and with the timesteps and noise that each step's
generator gives when replayed as DDPM training draws them (each micro-batch's
timesteps, then its noise).
"""

from __future__ import annotations

import contextlib
import gc
import os
import statistics
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bench_port import trace
from bench_port.common import (DTYPES, TraceContext, WindowResult, finite, full_f32, generator, load_weights,
                               subseed, sync)
from bench_port.reference import unet as ref_unet
from bench_port.reference.diffusion import Schedule, box_trigger, image_target, stamp_mask
from bench_port.reference.precision import BELOW, Precision
from bench_port.reference.train import B1, RefTrainer, names_moved
from bench_port.work.model import sites

MODE = "train"


def write_images(images: np.ndarray, path: str) -> None:
    """The benchmark's images as binary PPM (or PGM) files ``000000.ppm``,
    ... under ``path``, which holds nothing else afterwards."""
    os.makedirs(path, exist_ok=True)
    for name in os.listdir(path):
        os.remove(os.path.join(path, name))
    n, h, w, c = images.shape
    magic, ext = (b"P6", "ppm") if c == 3 else (b"P5", "pgm")
    header = magic + b"\n%d %d\n255\n" % (w, h)
    for i in range(n):
        with open(os.path.join(path, f"{i:06d}.{ext}"), "wb") as f:
            f.write(header + images[i].tobytes())


def match_rows(rows: np.ndarray, images: np.ndarray) -> List[Tuple[int, bool]]:
    """For each row, ``(index, mirrored)`` of the benchmark's image it is (or
    of whose left-right mirror it is), ``(-1, False)`` for a row that is
    neither."""
    table = {}
    for i in range(len(images)):
        table.setdefault(images[i, :, ::-1].tobytes(), (i, True))
        table[images[i].tobytes()] = (i, False)
    return [table.get(np.ascontiguousarray(r).tobytes(), (-1, False)) for r in rows]


def replay_draws(seed: int, batch: int, micro: int, shape, device: torch.device):
    """The timesteps and noise a step's generator gives, drawn as DDPM
    training draws them: each micro-batch's timesteps in [0, 1000), then its
    noise."""
    g = torch.Generator(device).manual_seed(seed)
    ts, eps = [], []
    for _ in range(batch // micro):
        ts.append(torch.randint(0, 1000, (micro,), generator=g, device=device))
        eps.append(torch.randn((micro,) + tuple(shape), generator=g, device=device))
    return torch.cat(ts), torch.cat(eps)


def gap(prog: float, ref: float) -> float:
    return abs(prog - ref) / max(abs(ref), 1e-30)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names) -> Dict[str, float]:
    """Each leaf's |‖a‖ − ‖b‖| over the larger of its reference norm and the
    median leaf's."""
    names = list(names)
    median = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30) for n in names}


def worst(label: str, gaps: Dict[str, float], prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """The worst leaf's gap; the three worst leaves go to standard error."""
    top = sorted(gaps, key=gaps.get, reverse=True)[:3]
    print(f"{label}: worst leaves " + "; ".join(f"{n} {gaps[n]:.3g} ({prog[n]:.4g} against {ref[n]:.4g})"
                                               for n in top), file=sys.stderr)
    return gaps[top[0]]


class Session:
    def __init__(self, cell, seed: int, device: torch.device, root: str):
        from baddiffusion_tpu_torch.data.datasets import DatasetLoader
        from baddiffusion_tpu_torch.data.prefetch import device_prefetch
        from baddiffusion_tpu_torch.models.unet2d import UNet2DConfig, UNet2DModel
        from baddiffusion_tpu_torch.schedulers import DDPMConfig, DDPMScheduler
        from baddiffusion_tpu_torch.training import create_train_state, make_optimizer, make_train_step
        from baddiffusion_tpu_torch.training.trainer import step_seed

        self.seed, self.device, self.root = seed, device, root
        tr = self.traffic = cell.traffic
        self.cfg = cell.unet
        self.dtype = tr["dtype"]
        self.size = self.cfg["sample_size"]
        self.channels = self.cfg["in_channels"]
        self.batch, self.micro = tr["global_batch"], tr["micro_batch"]
        self.accum = self.batch // self.micro
        self.warmup = max(1, tr["warmup_steps"] // self.accum)
        self._step_seed = step_seed
        torch.backends.cuda.matmul.allow_tf32 = bool(tr.get("matmul_tf32", False))
        torch.backends.cudnn.allow_tf32 = bool(tr.get("cudnn_tf32", True))

        self.model = UNet2DModel(UNet2DConfig(**self.cfg), device=device, dtype=DTYPES[self.dtype])
        weights = ref_unet.init_params(self.cfg, generator(device, seed, 1), device)
        load_weights(self.model, weights)
        self.optimizer, _ = make_optimizer(tr["lr"], num_warmup_steps=self.warmup,
                                           num_training_steps=tr["training_steps"], grad_clip=tr["clip"])
        shape = (tr["dataset_size"], self.size, self.size, self.channels)
        self.images = np.random.default_rng(subseed(seed, 2)).integers(0, 256, shape, dtype=np.uint8)
        folder = os.path.join(root, ".bench_cache", "images", f"{self.size}x{self.channels}")
        write_images(self.images, folder)
        self.dsl = DatasetLoader(folder, root=os.path.join(root, ".bench_cache", "datasets"), image_size=self.size,
                                 channel=self.channels, batch_size=self.batch, seed=subseed(seed, 3) % (1 << 31))
        self.dsl.set_poison(tr["trigger"], tr["target"], poison_rate=tr["poison_rate"]).prepare_dataset()
        self.state = create_train_state(self.model, self.optimizer, self.dsl.trigger, self.dsl.target, self.dsl.mask)
        schedule = DDPMScheduler(DDPMConfig(num_train_timesteps=1000)).create_state().schedule
        self.train_step = make_train_step(self.model, self.optimizer, 1000, schedule.alphas, schedule.alphas_cumprod,
                                          loss_type=tr["loss"], grad_accum=self.accum, use_remat=tr["remat"],
                                          device=device)
        self.stream = device_prefetch(self.dsl.get_dataloader(), device, size=tr["prefetch"])
        self.global_step = 0

        # the checked steps: the window's own step, its batch and generator seed kept
        self.inputs, self.prog_loss = [], []
        for i in range(tr["checked_steps"]):
            self._step(keep=self.inputs)
            self.prog_loss.append(float(self._metrics["loss"]))
            if i == 0:
                mu = self.state.opt_state.mu
                self.prog_grads = {n: float(torch.linalg.vector_norm(m_)) / (1.0 - B1)
                                   for n, m_ in zip(self.state.params, mu)}
        with torch.no_grad():
            self.prog_change = {n: float(torch.linalg.vector_norm(p.detach() - weights[n]))
                                for n, p in self.state.params.items()}
        self.w0 = {n: v.cpu() for n, v in weights.items()}
        self._ref = self._fed = None  # the f32 reference's readings and the feed's, once computed
        del weights
        for _ in range(tr["warm_steps"]):
            self._step()
        sync(device)

    def _step(self, spans: bool = False, keep: Optional[list] = None):
        ctx = torch.profiler.record_function if spans else (lambda name: contextlib.nullcontext())
        with ctx("bench.data_wait"):
            batch = next(self.stream)
        step_seed = self._step_seed(subseed(self.seed, 4), self.global_step)
        gen = torch.Generator(self.device).manual_seed(step_seed)
        if keep is not None:
            keep.append((batch["image_u8"].cpu().numpy(), batch["is_clean"].cpu().numpy(), step_seed))
        with ctx("bench.step"):
            self.state, self._metrics = self.train_step(self.state, batch["image_u8"], batch["is_clean"], gen)
        loss = None
        if self.global_step % self.traffic["loss_every"] == 0:
            with ctx("bench.loss_read"):
                loss = float(self._metrics["loss"])
        self.global_step += 1
        return loss

    def window(self, seconds: float) -> WindowResult:
        """The measured window; the 95th percentile of the step times needs
        the card's events (it is left out on the CPU)."""
        cuda = self.device.type == "cuda"
        marks, steps, failed = [], 0, 0
        sync(self.device)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            if cuda:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
            loss = self._step()
            if loss is not None and not finite(loss):
                failed += 1
            steps += 1
            if time.perf_counter() >= deadline:
                break
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        sync(self.device)
        rate = steps * self.batch / (time.perf_counter() - t0)
        metrics = {"train_samples_per_s": rate}
        if cuda:
            step_ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
            metrics["train_step_ms_p95"] = float(np.percentile(step_ms, 95))
        return WindowResult(metrics=metrics, attempted=steps, failed=failed, rate=rate)

    def traced(self, rate: float) -> TraceContext:
        from baddiffusion_tpu_torch import ops

        steps = self.traffic["trace_steps"]
        before = ops.launch_counts()

        def run():
            for _ in range(steps):
                self._step(spans=True)

        tl = trace.profile(run, lambda: sync(self.device), self.device.type == "cuda")
        after = ops.launch_counts()
        s = sites(self.cfg, self.size)
        return TraceContext(timeline=tl, mode=MODE, dtype=self.dtype, sites=s, steps=steps, rows=self.batch,
                            micro=self.micro, calls=self.accum, rate=rate,
                            launches={k: after[k] - before[k] for k in after}, flops_per_row=3.0 * s.product_flops,
                            save_stats=True)

    def release(self) -> None:
        """Free the program's state (and stop the feed's thread); keep the
        records' clean flags for the comparison."""
        self.flags = np.asarray(self.dsl.get_raw(np.arange(len(self.dsl)))["is_clean"], bool)
        self.stream.close()
        del self.stream, self.state, self.train_step, self.optimizer, self.model, self.dsl
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _feed(self) -> Tuple[Dict[str, float], list]:
        """The feed held to the benchmark's data, and the checked steps'
        inputs rebuilt from it: the benchmark's own images (mirrored where
        the feed mirrored them), the flags, and the replayed draws."""
        tr, dev = self.traffic, self.device
        unknown = mismatch = 0
        inputs = []
        for image_u8, is_clean, step_seed in self.inputs:
            rows = []
            for (i, mirrored), row_clean in zip(match_rows(image_u8, self.images), is_clean):
                if i < 0:
                    unknown += 1
                    rows.append(np.zeros_like(self.images[0]))
                    continue
                mismatch += int(bool(row_clean) != bool(self.flags[i]))
                rows.append(self.images[i, :, ::-1] if mirrored else self.images[i])
            t, eps = replay_draws(step_seed, self.batch, self.micro, (self.size, self.size, self.channels), dev)
            inputs.append((torch.from_numpy(np.stack(rows)).to(dev), torch.from_numpy(is_clean).to(dev), t, eps))
        poisoned = int((~self.flags).sum())
        numbers = {"rows_unknown": float(unknown), "flag_mismatch": float(mismatch),
                   "poison_rows_gap": abs(poisoned - tr["poison_rate"] * len(self.flags))}
        return numbers, inputs

    def _reference(self, inputs, prec: Optional[Precision], rows_kept: float):
        tr, dev = self.traffic, self.device
        trig = box_trigger(tr["trigger"], self.size, self.channels)
        target = image_target(os.path.join(self.root, tr["target_image"]), self.size, self.channels)
        as_t = lambda a: torch.tensor(a, device=dev)
        ref = RefTrainer(self.cfg, {n: v.to(dev) for n, v in self.w0.items()}, Schedule(dev), tr["lr"], self.warmup,
                         tr["training_steps"], tr["clip"], as_t(trig), as_t(target), as_t(stamp_mask(trig)),
                         prec=prec, rows_kept=rows_kept)
        losses, grads = [], None
        for i, (img, clean, t, eps) in enumerate(inputs):
            out = ref.step(img, clean, t, eps, micro=min(self.micro, tr["reference_rows"]))
            losses.append(out["loss"])
            if i == 0:
                grads = out["grad_norms"]
        change = ref.change_norms(self.w0)
        del ref
        return losses, grads, change

    def check(self, control: Optional[str] = None) -> Dict[str, float]:
        """The compared numbers: the program's (``control`` None) or, put in
        its place, the reference one precision lower (``"lower"``) or over
        half of each block's rows (``"half_batch"``)."""
        if self._fed is None:
            self._fed = self._feed()
        feed, inputs = self._fed
        with full_f32():
            if self._ref is None:
                self._ref = self._reference(inputs, None, 1.0)
            ref_loss, ref_grads, ref_change = self._ref
            if control is None:
                loss, grads, change = self.prog_loss, self.prog_grads, self.prog_change
            elif control == "lower":
                loss, grads, change = self._reference(inputs, Precision(BELOW[self.dtype]), 1.0)
            elif control == "half_batch":
                loss, grads, change = self._reference(inputs, None, 0.5)
            else:
                raise ValueError(f"control {control!r}")
        for i, (p, r) in enumerate(zip(loss, ref_loss)):
            print(f"checked step {i}: loss {p!r}, reference {r!r}", file=sys.stderr)
        moved = names_moved(ref_grads)
        grad_gaps = leaf_gaps(grads, ref_grads, ref_grads)
        return {
            **feed,
            "loss_gap": max(gap(p, r) for p, r in zip(loss, ref_loss)),
            "grad_gap_worst": worst("grad_gap", grad_gaps, grads, ref_grads),
            "grad_gap": statistics.median(grad_gaps.values()),
            "update_gap": worst("update_gap", leaf_gaps(change, ref_change, moved), change, ref_change),
        }
