"""Latent-diffusion measure traffic: back-to-back whole chains through
``LDMPipeline.__call__``, each batch half clean rows (from pixel noise) and
half backdoor rows (from pixel noise + trigger), as the command line's
``--mode measure`` samples a backdoored LDM.

Set-up builds the VQ-VAE and the UNet at the published widths (parameters
f32, computing in the mix's dtype), loads the benchmark's seeded weights
(``reference/vq.py``, ``reference/unet.py``), builds the DDIM scheduler from
the configuration's scheduler keys at the mix's η, takes the trigger from
the program's ``Backdoor`` and runs one full-batch chain of ``warm_steps``
DDIM steps with its encode and decode, so that every shape is warm. Each
chain's pixel noise is drawn from the seed; the pipeline VQ-encodes it, runs
the chain on the latents and quantizes and decodes the result, all inside
the window, as users pay them.

The window runs whole chains and ends at the end of the first chain that
finishes after its time ran out (after a synchronise); ``sample_imgs_per_s``
counts the images of the finished chains over the window's seconds. Hooks
(the benchmark's own, on the program's modules) copy the first chain's
objects to pinned host memory: the pixel init the encoder took and the
latents ``quant_conv`` gave; at every ``snapshot_every``-th step from an
offset drawn from the seed, the UNet's input x_k, its ε and the next step's
input x_{k+1} (the quantizer's input after the last step); the quantizer's
input, codes and output; and the decoded image. The traced window is one
chain of ``trace_steps`` DDIM steps with its encode and decode.

The comparison (after the window, with the program freed) against the plain
f32 reference, ``reference_rows`` rows at a time:

- ``init_gap``: the pixel init against the benchmark's noise plus the
  reference's own trigger on the backdoor rows; exact.
- ``latent_gap``: the encoded latents against the reference encoder's on the
  same pixels: the largest relative L2 over the rows.
- ``eps_gap``, ``step_gap`` at each snapshot step, as ``sample.py`` computes
  them: the program's ε against the reference UNet's on the same x_k, and
  the program's x_{k+1} against the reference DDIM step (η = 0) from x_k with
  the reference's ε, over the step's coefficient on ε times ‖ε‖, on the rows
  where ε's term is at least ``STEP_CONDITION`` of x_{k+1}'s norm.
- ``code_gap``: the latent vectors whose program code differs from the
  reference quantizer's on the program's own final latents, not counting
  near ties (``CODE_MARGIN``); their count is read as ``code_near_ties``.
- ``quant_gap``: the latent vectors whose quantized row, the quantizer's
  output, is not the codebook row of the program's code within the rounding
  of the straight-through form z + (z_q − z) (``QUANT_MARGIN``).
- ``image_gap``: the decoded image against the reference decoder's on the
  program's quantized latents: the largest relative L2 over the rows.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bench_port import trace
from bench_port.common import (DTYPES, TraceContext, WindowResult, full_f32, generator, load_weights, subseed,
                               sync)
from bench_port.reference import unet as ref_unet
from bench_port.reference import vq as ref_vq
from bench_port.reference.ddim import DDIM
from bench_port.reference.diffusion import box_trigger
from bench_port.reference.precision import BELOW, Precision
from bench_port.work.model import sites
from bench_port.work.vq import VQSites, vq_sites

MODE = "sample"
# as sample.py's: below this share of x_{k+1}'s norm, f32's rounding of x_{k+1} would read as a gap in ε
STEP_CONDITION = 1e-3
# A code is a near tie where the reference's distance to it exceeds its least by at most this share of
# ‖z‖² + ‖e‖². Each f32 distance ‖z‖² + ‖e‖² − 2 z·e (the reference's) or ‖e‖² − 2 z·e (the kernel's) is
# off by at most about 8 units of f32 rounding (2**-24) of ‖z‖² + ‖e‖² (three rounded squares or products a
# sum, two sums); two distances on each side make 32 units, 2**-19. Twice that: 2**-18, 3.8e-6.
CODE_MARGIN = 2.0 ** -18
# The quantizer returns z + (e − z) in f32 for its code's row e: two roundings, each at most 2**-24 of its result,
# so within 2**-24·(|e − z| + |z + (e − z)|) <= 2**-23·(|e| + |z|) of e to first order. Twice that: 2**-22.
QUANT_MARGIN = 2.0 ** -22
CODE_ROWS = 1 << 15  # latent vectors a block of the reference quantizer's [rows, K] distances
WARM_CHAIN, TRACE_CHAIN = 1 << 20, 1 << 21  # chain indices of the set-up's and the trace's chains


@dataclasses.dataclass
class LDMTraceContext(TraceContext):
    """``TraceContext`` with the VQ-VAE's work (``work/vq.py``), the traced
    chains and the quantizer's vectors a call, for the VQ readers."""

    vq: Optional[VQSites] = None
    chains: int = 0
    vectors: int = 0


class _Probe:
    """The benchmark's hooks on the program's modules: UNet steps and the
    first chain's snapshots."""

    def __init__(self, pipe, steps: int):
        self.steps = steps
        self.step = 0
        self.snaps: Dict = {}
        vq = pipe.vqvae
        self._handles = [
            pipe.unet.register_forward_pre_hook(self._unet_in),
            pipe.unet.register_forward_hook(self._unet_out),
            vq.encoder.register_forward_pre_hook(lambda m, a: self._keep("init", a[0])),
            vq.quant_conv.register_forward_hook(lambda m, a, out: self._keep("latents", out)),
            vq.quantize.register_forward_pre_hook(self._final),
            vq.quantize.register_forward_hook(self._codes),
            vq.decoder.register_forward_hook(lambda m, a, out: self._keep("image", out)),
        ]

    def arm(self, snaps=None):
        self.step, self.snaps = 0, snaps or {}

    def _keep(self, key, t: torch.Tensor, slot=None) -> None:
        slot = self.snaps if slot is None else self.snaps.get(slot)
        if slot is not None and key in slot:
            slot[key].copy_(t.detach(), non_blocking=True)
            slot["have_" + key] = True

    def _unet_in(self, module, args):
        self._keep("x", args[0], self.step)
        self._keep("x_next", args[0], self.step - 1)

    def _unet_out(self, module, args, out):
        self._keep("eps", out, self.step)
        self.step += 1

    def _codes(self, module, args, out):
        self._keep("quantized", out[0])
        self._keep("codes", out[1])

    def _final(self, module, args):
        self._keep("final", args[0])
        self._keep("x_next", args[0], self.steps - 1)

    def close(self):
        for h in self._handles:
            h.remove()


class Session:
    def __init__(self, cell, seed: int, device: torch.device, root: str):
        from baddiffusion_tpu_torch.data.triggers import Backdoor
        from baddiffusion_tpu_torch.models.unet2d import UNet2DConfig, UNet2DModel
        from baddiffusion_tpu_torch.models.vae import VQModel, VQModelConfig
        from baddiffusion_tpu_torch.pipelines.ldm import LDMPipeline
        from baddiffusion_tpu_torch.schedulers import DDIMConfig, DDIMScheduler

        self.seed, self.device = seed, device
        tr = self.traffic = cell.traffic
        if tr["segment_steps"]:
            raise ValueError("LDMPipeline runs eager chains only: segment_steps must be 0")
        self.cfg, self.vq_cfg, self.sched_cfg = cell.config["unet"], cell.config["vqvae"], cell.config["scheduler"]
        self.dtype = tr["dtype"]
        self.size, self.latent = self.vq_cfg["sample_size"], self.cfg["sample_size"]
        self.batch, self.clean_rows = tr["batch"], tr["clean_rows"]
        self.steps = tr["chain_steps"]
        self.shape = (self.batch, self.size, self.size, self.vq_cfg["in_channels"])
        self.latent_shape = (self.batch, self.latent, self.latent, self.cfg["in_channels"])
        torch.backends.cuda.matmul.allow_tf32 = bool(tr.get("matmul_tf32", False))
        torch.backends.cudnn.allow_tf32 = bool(tr.get("cudnn_tf32", True))

        dtype = DTYPES[self.dtype]
        unet = UNet2DModel(UNet2DConfig(**self.cfg), device=device, dtype=dtype)
        vqvae = VQModel(VQModelConfig(**self.vq_cfg), device=device, dtype=dtype)
        weights = self._weights()
        load_weights(unet, weights[0])
        load_weights(vqvae, weights[1])
        del weights
        scheduler = DDIMScheduler(DDIMConfig(**self.sched_cfg, eta=tr["eta"]))
        self.pipe = LDMPipeline(vqvae, unet, scheduler, device=device)
        trig = Backdoor().get_trigger(tr["trigger"], channel=self.shape[-1], image_size=self.size)
        self.trigger = torch.tensor(trig, device=device)
        self.probe = _Probe(self.pipe, self.steps)
        self.snaps = self._snap_buffers()
        self._ref: Dict = {}  # the f32 reference's objects, kept on the host between checks
        self._chain(WARM_CHAIN, steps=tr["warm_steps"])
        sync(device)

    def _weights(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """The benchmark's seeded weights of the UNet and the VQ-VAE, drawn on
        the device (the same draws every call)."""
        return (ref_unet.init_params(self.cfg, generator(self.device, self.seed, 1), self.device),
                ref_vq.init_params(self.vq_cfg, generator(self.device, self.seed, 2), self.device))

    def _snap_buffers(self) -> Dict:
        """Host buffers (pinned on the card) for the first chain's objects."""
        every = self.traffic["snapshot_every"]
        offset = int(np.random.default_rng(subseed(self.seed, 7)).integers(0, every))
        pin = self.device.type == "cuda"
        buf = lambda shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, pin_memory=pin)
        snaps = {"init": buf(self.shape), "latents": buf(self.latent_shape), "final": buf(self.latent_shape),
                 "quantized": buf(self.latent_shape), "codes": buf(self.latent_shape[:3], torch.int64),
                 "image": buf(self.shape[:3] + (self.vq_cfg["out_channels"],))}
        for k in range(offset, self.steps, every):
            snaps[k] = {key: buf(self.latent_shape) for key in ("x", "eps", "x_next")}
        return snaps

    def _init(self, chain: int):
        noise = torch.randn(self.shape, generator=generator(self.device, self.seed, 5, chain), device=self.device)
        init = noise.clone()
        init[self.clean_rows:] += self.trigger
        return noise, init

    def _chain(self, chain: int, steps: Optional[int] = None, snaps=None) -> None:
        """One pipeline call: the pixel init encoded, ``steps`` DDIM steps
        (the chain's length by default), the result quantized and decoded."""
        _, init = self._init(chain)
        self.probe.arm(snaps)
        self.pipe(batch_size=self.batch, generator=generator(self.device, self.seed, 6, chain), init=init,
                  num_inference_steps=steps or self.steps, output_type="pt")

    def window(self, seconds: float) -> WindowResult:
        sync(self.device)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        chains = 0
        while True:
            self._chain(chains, snaps=self.snaps if chains == 0 else None)
            sync(self.device)
            chains += 1
            if time.perf_counter() >= deadline:
                break
        elapsed = time.perf_counter() - t0
        images = self.batch * chains
        return WindowResult(metrics={"sample_imgs_per_s": images / elapsed}, attempted=images, failed=0,
                            rate=images * self.steps / elapsed)

    def traced(self, rate: float) -> LDMTraceContext:
        from baddiffusion_tpu_torch import ops

        steps = self.traffic["trace_steps"]
        before = ops.launch_counts()
        tl = trace.profile(lambda: self._chain(TRACE_CHAIN, steps=steps), lambda: sync(self.device),
                           self.device.type == "cuda")
        after = ops.launch_counts()
        s, v = sites(self.cfg, self.latent), vq_sites(self.vq_cfg)
        chain_flops = self.steps * s.product_flops + v.encode_flops + v.decode_flops
        return LDMTraceContext(timeline=tl, mode=MODE, dtype=self.dtype, sites=s, steps=steps, rows=self.batch,
                               micro=self.batch, calls=1, rate=rate,
                               launches={k: after[k] - before[k] for k in after},
                               flops_per_row=chain_flops / self.steps, save_stats=False, vq=v, chains=1,
                               vectors=self.batch * v.latent_size ** 2)

    def release(self) -> None:
        self.probe.close()
        del self.pipe, self.probe
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _compared(self) -> List[int]:
        """Every snapshot step of the first chain whose x_k, ε and next x all
        arrived before the window closed."""
        return sorted(k for k, s in self.snaps.items()
                      if isinstance(k, int) and s.get("have_x") and s.get("have_eps") and s.get("have_x_next"))

    def _blocks(self):
        rows = self.traffic["reference_rows"]
        return [slice(r, r + rows) for r in range(0, self.batch, rows)]

    def _reference(self, key, fn):
        """The f32 reference's ``fn()``, computed once and kept on the host."""
        if key not in self._ref:
            self._ref[key] = fn()
        return self._ref[key]

    def check(self, control: Optional[str] = None) -> Dict[str, float]:
        """The compared numbers: the program's (``control`` None) or, put in
        its place, the reference one precision lower (``"lower"``)."""
        if control not in (None, "lower"):
            raise ValueError(f"control {control!r}")
        dev, snaps = self.device, self.snaps
        prec = None if control is None else Precision(BELOW[self.dtype])
        pu, pv = self._weights()
        ddim = DDIM(self.sched_cfg)
        ts = ddim.timesteps(self.steps)
        dims = (1, 2, 3)
        rel = lambda a, b: torch.linalg.vector_norm(a - b, dim=dims) / torch.linalg.vector_norm(b, dim=dims)
        out = {}

        expected = self._init(0)[0].cpu()
        expected[self.clean_rows:] += torch.tensor(box_trigger(self.traffic["trigger"], self.size, self.shape[-1]))
        out["init_gap"] = float((snaps["init"] - expected).abs().max()) if snaps.get("have_init") else float("inf")

        with full_f32(), torch.no_grad():
            gaps = {"latent_gap": [], "eps_gap": [], "step_gap": [], "image_gap": []}
            have_vq = all(snaps.get("have_" + k) for k in ("latents", "final", "quantized", "codes", "image"))
            for i, sl in enumerate(self._blocks()):
                if not have_vq:
                    break
                x = snaps["init"][sl].to(dev)
                ref = self._reference(("latents", i), lambda: ref_vq.encode(pv, self.vq_cfg, x).cpu()).to(dev)
                got = snaps["latents"][sl].to(dev) if prec is None else ref_vq.encode(pv, self.vq_cfg, x, prec)
                gaps["latent_gap"].append(float(rel(got, ref).max()))
                zq = snaps["quantized"][sl].to(dev)
                ref = self._reference(("image", i), lambda: ref_vq.decode(pv, self.vq_cfg, zq).cpu()).to(dev)
                got = snaps["image"][sl].to(dev) if prec is None else ref_vq.decode(pv, self.vq_cfg, zq, prec)
                gaps["image_gap"].append(float(rel(got, ref).max()))
            for k in self._compared():
                s, t = snaps[k], int(ts[k])
                for i, sl in enumerate(self._blocks()):
                    x = s["x"][sl].to(dev)
                    tt = torch.full((x.shape[0],), t, device=dev, dtype=torch.long)

                    def reference():
                        eps = ref_unet.forward(pu, self.cfg, x, tt)
                        nxt, coef = ddim.step(x, eps, t, self.steps)
                        return eps.cpu(), nxt.cpu(), coef

                    eps_ref, nxt_ref, coef = self._reference((k, i), reference)
                    eps_ref, nxt_ref = eps_ref.to(dev), nxt_ref.to(dev)
                    if prec is None:
                        eps, nxt = s["eps"][sl].to(dev), s["x_next"][sl].to(dev)
                    else:
                        eps = ref_unet.forward(pu, self.cfg, x, tt, prec)
                        nxt = ddim.step(x, eps, t, self.steps)[0]
                    gaps["eps_gap"].append(float(rel(eps, eps_ref).max()))
                    # x enters both sides alike: the gap over k is the gap in the ε the step applied
                    moved = coef * torch.linalg.vector_norm(eps_ref, dim=dims)
                    sound = moved >= STEP_CONDITION * torch.linalg.vector_norm(nxt_ref, dim=dims)
                    if bool(sound.any()):
                        sg = torch.linalg.vector_norm(nxt - nxt_ref, dim=dims) / moved
                        gaps["step_gap"].append(float(sg[sound].max()))
            for key, values in gaps.items():
                out[key] = max(values) if values else float("inf")
            if have_vq:
                codebook = pv["quantize.embedding.weight"]
                out["code_gap"], out["code_near_ties"] = self._code_gap(codebook, prec)
                # the reference's quantized rows are its codebook's rows by construction: the control reads 0
                out["quant_gap"] = self._quant_gap(codebook) if prec is None else 0.0
            else:
                out["code_gap"] = out["quant_gap"] = float("inf")
        return out

    def _codes(self, r: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The program's codes of vectors ``r`` to ``r + CODE_ROWS`` on the
        device, those outside the codebook's ``k`` rows set to 0, and which
        they were."""
        got = self.snaps["codes"].reshape(-1)[r:r + CODE_ROWS].to(self.device)
        outside = (got < 0) | (got >= k)
        return got.masked_fill(outside, 0), outside

    def _quant_gap(self, codebook: torch.Tensor) -> float:
        """Vectors whose quantized row is not their code's codebook row
        within ``QUANT_MARGIN`` of |e| + |z| in some element, or whose code
        lies outside the codebook."""
        dim = codebook.shape[1]
        flat, quantized = self.snaps["final"].reshape(-1, dim), self.snaps["quantized"].reshape(-1, dim)
        gap = 0
        for r in range(0, flat.shape[0], CODE_ROWS):
            z, q = flat[r:r + CODE_ROWS].to(self.device), quantized[r:r + CODE_ROWS].to(self.device)
            got, outside = self._codes(r, codebook.shape[0])
            e = codebook[got]
            off = ~((q - e).abs() <= QUANT_MARGIN * (e.abs() + z.abs())).all(dim=1)  # a NaN is off
            gap += int((off | outside).sum())
        return float(gap)

    def _code_gap(self, codebook: torch.Tensor, prec: Optional[Precision]) -> Tuple[float, float]:
        """(vectors whose code differs from the reference's beyond a near tie,
        the near ties) on the program's final latents; with ``prec`` the
        codes are the reference's own in that precision."""
        flat = self.snaps["final"].reshape(-1, codebook.shape[1])
        norms = codebook.square().sum(dim=1)
        gap = ties = 0
        for r in range(0, flat.shape[0], CODE_ROWS):
            z = flat[r:r + CODE_ROWS].to(self.device)
            d = ref_vq.distances(codebook, z)
            least, best = d.min(dim=1)
            if prec is None:
                got, outside = self._codes(r, codebook.shape[0])
            else:
                got = torch.argmin(ref_vq.distances(codebook, z, prec), dim=1)
                outside = torch.zeros_like(got, dtype=torch.bool)
            over = d.gather(1, got[:, None])[:, 0] - least
            near = (over <= CODE_MARGIN * (z.square().sum(dim=1) + norms[got])) & ~outside
            differ = (got != best) | outside
            gap += int((differ & ~near).sum())
            ties += int((differ & near).sum())
        return float(gap), float(ties)
