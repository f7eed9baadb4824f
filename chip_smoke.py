#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Environment: the card's name and power limit, torch and CUDA versions,
   the kernels' build time (nvcc, from the sources in the checkout). TF32 is
   off for cuDNN and cuBLAS so the f32 checks compare full f32.
2. Kernels against their plain PyTorch versions on the card, at every shape
   the main paths give them (batch 128), in bf16 and f32, with the device
   time (torch.profiler) of the kernel, the plain version and one PyTorch
   library call, and the least time the card could take (bytes over
   3.35 TB/s or operations over peak): GroupNorm+SiLU forward (K1; its
   launch plan printed at each timed shape, its [B, G] statistics against
   the plain ones, output and statistics bitwise equal over two calls, and
   the same checks at the sampling batch 16 and at a 128 px slab too large
   to stage) and backward (K2; its launch plan printed at each timed shape,
   also against autograd through the plain forward, dx, dγ and dβ bitwise
   equal over two calls, the same checks at a 128 px slab too large to
   stage, and the device time of its second kernel, the sum of dγ/dβ over
   the batch, apart), attention (K3; its launch plan printed at each shape:
   the main path's two shapes at batch 128 and 16, the scratch UNet at
   256 px, google/ddpm-cifar10-32, google/ddpm-ema-celebahq-256's 512-wide
   head, T = 1024 and a ragged T; each in f32 and bf16 against the plain
   version and bitwise equal over two calls, timed in bf16 and, for the f32
   measure's shapes, in f32 too; its bound also counts the exponentials, over
   the special-function rate, and the tf32x3 plan's f32 products at three
   TF32 products over the TF32 rate). Then phase 9's shapes,
   each against its plain twin and bitwise over two calls, timed in the
   dtype its path runs in beside its bound and library call: K1 and K2 at
   CompVis/ldm-celebahq-256's UNet widths at B=16 (C = 224, 448, 672, 896
   at 64, 32, 16 and 8 px: group widths 7-28, bf16) and its VQ-VAE's
   [16, 256, 256, 128] (f32); K3 at the envelope's long end, the VQ-VAE's
   [16, 1, 4096, 512] (f32 and bf16), the LDM UNet's heads of 32 at 32, 16
   and 8 px, and NCSN++ at 16x16 (these four in f32 too: the measure runs
   f32). Last, the conv bias-shift pair at the benchmark cells' shapes
   (google/ddpm-ema-celebahq-256's 256² and 8² levels and conv_out at B=16
   in bf16, google/ddpm-cifar10-32's measure at B=256 in f32): the forward
   bitwise its twin and in place, the gradients against the twin and
   bitwise over two calls, timed beside the aten passes it replaced and its
   byte bound. Then the VQ nearest-code search at the LDM measure's decode
   (1,048,576 vectors of 3 against 8192 codes): its codes the twin's (in
   row blocks) but for near ties, z_q codebook[idx] bitwise, bitwise over
   two calls, at most 1 GiB beyond its outputs, timed beside the twin,
   torch.cdist + argmin and its operation bound. Where two calls differ, the
   differing elements and a third call are printed before the failure.
3. The sampling path: the full-width scratch UNet (113.7M parameters, 32 px)
   with seeded weights, saved and reloaded through the pipeline's HF layout,
   one f32 forward and a 10-step f32 chain checked against the CPU's plain
   path, then 1000-step bf16 DDPM sampling from noise and from noise +
   trigger (BOX_14); then where the time goes: a profiled 20-step bf16 chain
   and timed bf16 forwards at batch 16 and 128, split by layer.
4. The training path (bench.py's backdoor train step): one f32 step at
   batch 2 on the card against the CPU's plain path (loss, grad norm,
   updated parameters), then bf16-compute steps with f32 parameters at batch
   128 with bench.py's optimizer (lr 2e-4, 500 warmup of 10,000 steps),
   poisoning BOX_14 -> CORNER at rate 0.1: warm-up steps, then timed steps;
   then the device time of a step split into forward, backward and optimizer.
5. Launch counts over each main path's run (the sampling chains of phase 3,
   the timed train steps of phase 4, the two train_loop runs of phase 6,
   the zoo's chains of phase 7, the CLI and ANP runs of phase 8, the
   windows of phase 9; counters set to 0 just before each and read just
   after): every GroupNorm+SiLU, attention and conv call must have gone
   through its kernel, 65 K1, 6 K3 and 96 bias_shift per scratch UNet
   forward and, in training and ANP, 65 K2 and 96 bias_shift_backward per
   step (phase 9's counts are its own, below).
6. The trainer path (run after phase 4): train_loop on the scratch UNet at
   bf16 compute with f32 parameters, on DatasetLoader("FAKE", 1024 images,
   32 px, batch 128, seed 0) poisoned BOX_14 -> CORNER at 0.1, with
   bench.py's optimizer, a Tracker, device prefetch, 4x4 sample grids (clean
   and backdoor, with the movie's first frame) and a checkpoint every epoch,
   for 2 epochs; then the checkpoint restored into a fresh model and state
   and train_loop resumed to 3 epochs. The grids sample 50 steps, not 1000
   (phase 3 runs the 1000-step chain): a cut in depth only. Checked: every
   logged loss finite, one metrics.jsonl record a step and one a save; every grid a
   138x138x3 PNG; data.json's epoch and step; the restored parameters, Adam
   moments, count and step, and the HF export's weights, bitwise those of the
   live state at the save; the resumed loop's start and end steps; an async
   ``save_trainer_state``, with a train step run before it is finished,
   read back bitwise and returned in less time than a sync save took; the
   same through ``save_checkpoint`` (with its HF export). Printed: the
   loop's ms a step and samples/s beside phase 4's bare step, a grid's
   sampling time, a sync save's and the HF export's time, a save's parts
   (the host copy to pinned memory as the save makes it, reusing the
   pinned blocks that PyTorch's host allocator kept from the save before;
   into fresh pinned memory, that cache emptied; and to pageable memory;
   ``write_safetensors`` from the host copy), the async saves'
   return times, the phase's peak memory.

7. The sampler zoo (run after phase 3): the factory's 13 scheduler names
   past DDPM (DDIM, DPM-Solver and DPM-Solver++ of orders 1-3, UniPC, PNDM,
   DEIS, Heun, K-LMS, SDE-VE) and Karras-VE. (a) Each chain with the tests'
   stand-in denoiser, 0.1*x + 0.05*sin(t/100), 10 steps at [16, 32, 32, 3]
   f32, on the card against the CPU from the same init and noise (max err
   <= 1e-4*max|x| + 1e-4). (b) DDIM and DPM-Solver++ O2 on the full-width
   scratch UNet in f32, 5 steps at B=2, card against CPU (rtol 1e-3, atol
   1e-3*max|y|). (c) The path: every chain through DiffusionPipeline on the
   full-width UNet in bf16 at B=16 from noise + trigger (BOX_14), at its
   factory default length (50 steps; SDE-VE 100, not its 2000: a cut in
   depth only), under torch.cuda.set_sync_debug_mode("error"), so that no
   step synchronises; the sample before the clip finite, the images in
   [0, 1], each chain's UNet forwards as designed. (d) Each chain's ms a
   step, imgs/s and forwards; a profiled DPM-Solver++ O2 chain's device ms a
   step and idle share; DPM-Solver++ O2 again at B=128.

8. The command lines and the measure (run after phase 6), on the full-width
   scratch UNet at 32 px, in a scratch directory (deleted after) that is
   also the working directory, so the cwd-relative real-image dump lands
   there. (a) ``cli.main`` --mode train+measure: FAKE 1024 images, batch
   128, 1 epoch (8 steps), BOX_14 -> CORNER at 0.1, DDIM-SCHED, grids of 50
   steps, a measure of 256 clean and 256 backdoor images in chunks of 128
   with 50-step DDIM chains, and ``-isame`` so that epoch 0 has its export
   for (b); checked: the run dir's files, data.json's step, 256 + 256
   PNGs, score.json's FID_proxy, MSE and SSIM finite, SSIM in [-1, 1].
   (b) --mode sampling on that run dir (the grids), then --mode measure
   --sample_ep 0 (the _ep0 keys; epoch 0's export is the final weights, so
   its scores match the bare ones). (c) ``anp_cli.main`` on that run dir:
   1 epoch at batch 128 (8 steps), measure 128 images, 50-step chains,
   budget 4.0; checked: every logged loss finite, every γ/β within ±4 after
   every step, score.json's MSE/SSIM with *_best, the export reloaded
   through ``factory.get_trained`` and finite. (d) Card against CPU: mse,
   ssim, the proxy extractor (on 256 images) and FIDInceptionV3 (seeded
   random weights, f32, [16, 32, 32, 3] -> 299²), rtol 1e-4 with atol
   1e-4*max|y| for the activations; the FID of two seeded 256-image sets
   (proxy), rtol 1e-3. (e) The CLI's ms a train step and the ANP step's
   (CUDA events between step starts), the measure chains' imgs/s, the
   Inception's imgs/s at batch 128, the phase's wall time and peak memory.
   Cuts, in depth only: the measure runs 50 DDIM steps, not the
   reference's 1000 DDPM steps (phase 3 runs the 1000-step chain), and 256
   images, not 2048; the ANP runs 1 epoch and 50-step chains, not 1000.
   The f32 chains run without TF32 (phase 1's setting).

9. The latent-diffusion path and the NCSN++ family (run last). (a)
   CompVis/ldm-celebahq-256 at full width (``model_configs``: the 274.1M
   UNet at 64 px, the 55.3M VQ-VAE at 256 px with 8192 codes, DDIM over
   scaled-linear betas), staged with seeded weights by ``stage_ldm`` into a
   scratch run dir (deleted after) and reloaded through
   ``factory.get_pretrained``, weights exact; a VQ decode (of nudged
   codebook rows), an encode and a UNet forward in f32 on the card against
   the CPU at B=1 (rtol 1e-3, atol 1e-3*max|y|); two 50-step DDIM chains in
   bf16 (VQ-VAE f32) at B=16 from pixel noise and noise + BOX_14, encoded
   to latents and decoded, images finite in [0, 1]; then ``cli.main``
   --mode sampling (50-step grids with their movies) and --mode measure (16
   + 16 images, 50 steps, f32) on the run dir, files and scores checked.
   Printed: the chains' imgs/s and ms a step, the VQ encode's and decode's
   and a bf16 UNet forward's ms at B=16, the CLI's times, peak memory. (b)
   google/ncsnpp-celebahq-256 at full width (65.6M, 256 px): an f32 forward
   card against CPU at B=1; a 10-step SDE-VE chain in bf16 at B=2 (its
   default is 2000); 4 VE score steps at B=4 in bf16 on f32 parameters
   (losses and grad norms finite). Cuts in depth only. Launch counts over
   each counted window, from the module calls the window made: (K1, K3,
   bias_shift) a call of the LDM UNet (45, 16, 67), the VQ encoder with its
   quant_conv (17, 1, 23) and decoder with its post_quant_conv (23, 1, 29),
   NCSN++ (105, 4, 146), and a K2 for every K1 and a bias_shift_backward
   for every conv of a score step.

10. The reference's own recipes (run last). (a) google/ddpm-cifar10-32 at
   full width (``model_configs.DDPM_CIFAR10_32``, 35.7M), staged as a seeded
   pipeline directory with an args.json (``stage_ddpm``) and reloaded
   through ``factory.get_pretrained``, weights exact; an f32 forward card
   against CPU at B=2; ``cli.main --mode train --ckpt <the dir>`` on FAKE
   512 at batch 128 (4 bf16 steps, 50-step grids, the export); a 50-step
   bf16 DDPM chain at B=16; profiled windows of a chain and a train step.
   (b) google/ddpm-ema-celebahq-256 at full width (113.7M, 256 px): an f32
   forward card against CPU at B=1; a 50-step bf16 DDIM chain at B=8; two
   steps of bench.py's 256 px recipe (micro-batch 4 x grad-accum 16, bf16
   on f32 parameters); profiled windows of each. (c) The demos through
   their ``run(...)``, cut in depth: the attack 300 of 3000 steps, 16 of 64
   images, 100-step chains; the defense on that run, 20 of 300 ANP steps,
   its before-ANP MSE the attack's own (rtol 1e-2); the VE score model 50
   of 4000 steps and a 20-step PC chain of 64 images; their files and
   finite scores checked (not the attack's outcome, which needs the full
   length); profiled windows of the attack model's train step and chain.
   Launch counts over each counted window from its UNet forwards, with and
   without a backward: (K1, K3, bias_shift) a forward (45, 6, 65), (65, 6,
   96), the attack demo model's (35, 6, 51) and the score model's (35, 6,
   50), derived from the configs, and a K2 for every K1 and a
   bias_shift_backward for every conv of a forward with a backward. Profiling goes through
   ``baddiffusion_tpu_torch.utils.profiling``.

11. Scale-out (run last), the full-width scratch UNet at B=128. (a) One
   bf16 train step through a one-rank NCCL world (``parallel.initialize``
   on a FileStore, ``make_mesh``, a replicated ``ParallelLayout``): bitwise
   the bare step's loss, grad norm and parameters on the same weights,
   batch and draws. (b) Two ranks sharing the card over gloo (``--gpu
   0,0``; this script run as ``--scaleout-rank`` subprocesses), 64 rows
   each, in four layouts: replicated, FSDP, TP (data 1 x model 2) and TP +
   FSDP. Per layout: 2 f32 steps against the one-rank f32 steps at B=128
   (loss and grad norm rtol 1e-4; parameters within 2*lr a step, all but
   1e-3 of them within 1e-6); 3 bf16 steps with bench.py's optimizer, the
   ranks bitwise equal, a checkpoint after step 2; then a fresh pair of
   ranks restores it and repeats step 3 bitwise. Each rank's launch counts
   (65 K1, 65 K2, 6 K3 a step), ms a step per rank and the share spent in
   the collectives (gloo goes through the host: no measure of NCCL across
   cards). (c) ``cli.main`` train+measure (FAKE 256, batch 128, DDIM grids
   and a measure of 32 + 32 images at 10 steps) and ``anp_cli`` (1 epoch) on
   the two ranks: rank 0's files and scores; each rank's launches against
   its UNet forwards.

12. Segment mode (run last; (c) at the end of phase 8, on its run dir):
   chains as CUDA graphs of N steps (``pipelines/segments.py``), the
   full-width scratch UNet in bf16. (a) A 100-step DDPM chain at B=128 from
   noise + BOX_14 in segments of 25 and of 30 (a remainder segment), each
   bitwise the eager chain (sample, images, and the caller's generator
   state after); a second generator replays the cached graphs bitwise its
   own eager chain; capture_every=3 (the movie) and start_from=4 bitwise.
   (b) DDIM, DPM-Solver++ O2, UniPC, PNDM and SDE-VE (with its corrector) at
   B=16, 20 steps, segments of 7, each bitwise its eager chain. (c) ``cli
   --mode measure --sample_ep 0 --sample_segment 25`` on phase 8's run dir
   after its real-image dump is deleted: its PNGs byte for byte and
   score.json's _ep0 scores those of phase 8 (b)'s unsegmented measure, and
   the native PNG codec's counters show that it wrote the dump and the
   chunks and read them back. (d) The ms a chain step eager and replayed at
   B=16 and 128, the capture time a chain, a profiled replay (device ms, idle
   share, K1 and K3 by kernel name), and one more replayed chain whose K1
   and K3 kernels the profiler counts, against 65 and 6 a forward and
   against the launch counters over the same call. Launch counts over (a)+(b)+(d) and over
   (c): 65 K1 and 6 K3 a UNet forward, each capture's warm-up forward among
   them (the counters add a graph's captured launches at each replay).

The last line is {"ok": true, "device": {...}}; the line before it lists every
kernel with its numbers. Any failed check raises, and the script exits
non-zero. Without CUDA it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from baddiffusion_tpu_torch import anp_cli, cli, factory, native, ops, parallel
from baddiffusion_tpu_torch import model_configs as mc
from baddiffusion_tpu_torch.data import Backdoor, DatasetLoader, trigger_mask
from baddiffusion_tpu_torch.defense import perturb_leaves
from baddiffusion_tpu_torch.examples import attack_demo, defense_demo, train_sde_ve
from baddiffusion_tpu_torch.metrics import fid, mse, proxy_extractor, ssim
from baddiffusion_tpu_torch.models import (
    DEFAULT_SCRATCH_CONFIG,
    AttentionBlock,
    Conv2d,
    Decoder,
    Encoder,
    GroupNorm,
    UNet2DModel,
)
from baddiffusion_tpu_torch.models.inception import FIDInceptionV3
from baddiffusion_tpu_torch.ops import _build
from baddiffusion_tpu_torch.parallel import distributed
from baddiffusion_tpu_torch.pipelines import DiffusionPipeline, LDMPipeline, sample_chain, segments
from baddiffusion_tpu_torch.schedulers import (
    DDIMConfig,
    DDIMScheduler,
    DDPMConfig,
    DDPMScheduler,
    KarrasVeScheduler,
    ScoreSdeVeScheduler,
)
from baddiffusion_tpu_torch.training import (
    create_score_train_state,
    create_train_state,
    finish_async_saves,
    load_trainer_state,
    make_optimizer,
    make_train_step,
    make_ve_train_step,
    save_checkpoint,
    save_trainer_state,
    train_loop,
)
from baddiffusion_tpu_torch.training import checkpoint as checkpoint_module
from baddiffusion_tpu_torch.training.trainer import step_seed
from baddiffusion_tpu_torch.utils import Tracker, profiling
from baddiffusion_tpu_torch.utils.profiling import device_profile, time_ms

ROOT = os.path.dirname(os.path.abspath(__file__))
TMP_BASE = os.path.join(ROOT, ".chip_smoke_tmp")

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12,
                  # K3's tf32x3 plan: f32 products as three TF32 tensor-core products (495 TFLOP/s)
                  "tf32x3": 495e12 / 3}
# exponentials per second of the special-function units, H100 SXM5
# (FlashAttention-3, Shah et al., 2024, section 3.1): the softmax's bound
PEAK_EXP_PER_S = 3.9e12

BATCH = 128
GROUPS = 32
EPS = 1e-5
# GroupNorm+SiLU (H, W, C) -> calls per forward of the 32 px scratch UNet
GN_SHAPES = {
    (32, 32, 128): 8, (32, 32, 256): 3, (16, 16, 128): 7, (16, 16, 256): 2, (16, 16, 384): 1,
    (8, 8, 128): 1, (8, 8, 256): 6, (8, 8, 384): 1, (8, 8, 512): 2, (4, 4, 256): 7, (4, 4, 512): 2,
    (4, 4, 768): 1, (2, 2, 256): 1, (2, 2, 512): 6, (2, 2, 768): 1, (2, 2, 1024): 2, (1, 1, 512): 11,
    (1, 1, 1024): 3,
}
GN_FLOPS_PER_ELEMENT = 10  # sum, sum of squares, normalise, affine, SiLU
GN_BWD_FLOPS_PER_ELEMENT = 20  # x-hat, affine, SiLU', two group sums, dγ/dβ sums, dx
# attention [B, H, T, D] -> calls per forward of the main path at batch 128 (0:
# checked and timed, not counted): the 32 px scratch UNet at batch 128 and at
# the sampling batch 16, the scratch UNet at 256 px (micro-batch 4),
# google/ddpm-cifar10-32 at batch 16, the envelope's long end,
# google/ddpm-ema-celebahq-256's one 512-wide head, a ragged T
ATTN_SHAPES = {
    (BATCH, 64, 4, 8): 5, (BATCH, 64, 1, 8): 1, (16, 64, 4, 8): 0, (16, 64, 1, 8): 0, (4, 64, 256, 8): 0,
    (4, 64, 64, 8): 0, (16, 1, 256, 256): 0, (16, 1, 16, 256): 0, (4, 8, 1024, 64): 0, (2, 1, 256, 512): 0,
    (2, 3, 100, 64): 0,
    # phase 10's: google/ddpm-cifar10-32 fine-tuned at batch 128, google/ddpm-ema-celebahq-256's DDIM chain at
    # batch 8 and its 256 px step at micro-batch 4, the demo models' train steps at 128 and chains at 16
    (128, 1, 256, 256): 0, (128, 1, 16, 256): 0, (8, 1, 256, 512): 0, (8, 1, 64, 512): 0, (4, 1, 256, 512): 0,
    (4, 1, 64, 512): 0, (128, 16, 256, 8): 0, (128, 32, 64, 8): 0, (16, 16, 256, 8): 0, (16, 32, 64, 8): 0,
}
ATTN_SAMPLING = {(16, 64, 4, 8): 5, (16, 64, 1, 8): 1}  # a UNet forward at the sampling batch
# the shapes of ATTN_SHAPES timed in f32 too: the f32 measure's, google/ddpm-cifar10-32 at batch 16 and
# google/ddpm-ema-celebahq-256 at batch 8, and the 256 px scratch UNet's
ATTN_F32_TIMED = {(16, 1, 256, 256), (16, 1, 16, 256), (8, 1, 256, 512), (8, 1, 64, 512), (4, 64, 256, 8)}
# phase 9's shapes, checked and timed in the dtype their path runs in (not
# counted into the scratch UNet's per-forward sums): GroupNorm+SiLU (B, H, W,
# C) of CompVis/ldm-celebahq-256's UNet at the sampling batch (group widths 7,
# 14, 21, 28) and of its VQ-VAE's 256 px decoder stage, f32
GN_LATENT_SHAPES = {(16, 64, 64, 224): torch.bfloat16, (16, 32, 32, 448): torch.bfloat16,
                    (16, 16, 16, 672): torch.bfloat16, (16, 8, 8, 896): torch.bfloat16,
                    (16, 256, 256, 128): torch.float32,
                    # phase 10: google/ddpm-ema-celebahq-256's first level in its 256 px step (micro-batch 4)
                    (4, 256, 256, 128): torch.bfloat16}
# attention [B, H, T, D]: the VQ-VAE's mid block at the 64x64 latent (the
# envelope's long end), timed in both dtypes; the LDM UNet's three attention
# resolutions at B=16 (448, 672 and 896 channels in heads of 32; timed in
# both dtypes: bf16 chains, an f32 measure), the same resolutions with one
# level's fewer heads each, and NCSN++ 256 px at 16x16 and the score step's
# batch (both dtypes); None: both
ATTN_LATENT_SHAPES = {(16, 1, 4096, 512): None, (16, 14, 1024, 32): None,
                      (16, 21, 256, 32): None, (16, 28, 64, 32): None,
                      (16, 7, 1024, 32): torch.bfloat16, (16, 14, 256, 32): torch.bfloat16,
                      (16, 21, 64, 32): torch.bfloat16, (4, 32, 256, 8): None}
GN_PER_FORWARD = sum(GN_SHAPES.values())
ATTN_PER_FORWARD = sum(ATTN_SHAPES.values())
CONV_PER_FORWARD = 96  # the scratch UNet's Conv2d modules, each a bias_shift launch a forward (its backward one)
TOL = {torch.float32: dict(atol=1e-5, rtol=0.0), torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}

SAMPLE_BATCH = 16
SAMPLE_STEPS = 1000
PROFILE_STEPS = 20
# the train step: bench.py's batch, optimizer and poisoning
TRAIN_LR, TRAIN_WARMUP, TRAIN_TOTAL = 2e-4, 500, 10_000
POISON_RATE = 0.1
TRAIN_WARMUP_CALLS = 3
TRAIN_TIMED_STEPS = 20
TRAIN_PROFILE_STEPS = 3
# the trainer path: FAKE images, epochs of the first run and of the resumed
# one, the grids' batch and chain length (1000 in phase 3: a cut in depth)
TRAINER_FAKE_SIZE = 1024
TRAINER_EPOCHS, TRAINER_RESUME_EPOCHS = 2, 3
TRAINER_SAMPLE_N = 16
TRAINER_SAMPLING_STEPS = 50
GRID_PX = 4 * 32 + 5 * 2  # a 4x4 grid of 32 px images, 2 px borders
# the sampler zoo: the factory's names past DDPM (phase 3 runs DDPM), and Karras-VE
_S = factory.DiffuserModelSched
ZOO_NAMES = (_S.DDIM_SCHED, _S.DPM_SOLVER_PP_O1_SCHED, _S.DPM_SOLVER_O1_SCHED, _S.DPM_SOLVER_PP_O2_SCHED,
             _S.DPM_SOLVER_O2_SCHED, _S.DPM_SOLVER_PP_O3_SCHED, _S.DPM_SOLVER_O3_SCHED, _S.UNIPC_SCHED, _S.PNDM_SCHED,
             _S.DEIS_SCHED, _S.HEUN_SCHED, _S.LMSD_SCHED, _S.SCORE_SDE_VE_SCHED, "KARRAS-VE")
ZOO_STANDIN_SHAPE, ZOO_STANDIN_STEPS = (16, 32, 32, 3), 10
ZOO_F32_CHAINS, ZOO_F32_STEPS = (_S.DDIM_SCHED, _S.DPM_SOLVER_PP_O2_SCHED), 5
ZOO_SDE_STEPS = 100  # SDE-VE's default is 2000: a cut in depth only
# phase 8: the CLI's run, its measure and the ANP run, cut in depth
CLI_FAKE_SIZE = 1024
CLI_STEPS = 50  # DDIM steps of the grids and the measure (the reference measures with 1000 DDPM steps)
CLI_MEASURE_N, CLI_EVAL_BATCH = 256, 128
ANP_MEASURE_N, ANP_BUDGET = 128, 4.0
INCEPTION_CHECK_SHAPE, INCEPTION_BATCH = (16, 32, 32, 3), 128
# phase 9: LDM-CELEBA-HQ-256 and NCSN++ 256 px at full width, cut in depth; the (K1, K3, bias_shift) launches
# of one call of each module, derived from the configs (two K1 a resnet, one a fused output norm, one K3 an
# attention, one bias_shift a conv)
LDM_BATCH, LDM_STEPS, LDM_MEASURE_N, LDM_FAKE_SIZE = 16, 50, 16, 128
GPU = "0"  # phase 9's and 10's command lines' --gpu
# the VQ-VAE's encoder with its quant_conv, its decoder with its post_quant_conv
LDM_KERNEL_CALLS = {"UNet2DModel": (45, 16, 67), "Encoder": (17, 1, 23), "Decoder": (23, 1, 29)}
NCSNPP_KERNEL_CALLS = (105, 4, 146)
NCSNPP_CHAIN_BATCH, NCSNPP_CHAIN_STEPS = 2, 10
NCSNPP_TRAIN_BATCH, NCSNPP_TRAIN_STEPS, NCSNPP_LR = 4, 4, 2e-5  # the reference's 256 px scratch rate
# phase 10: google/ddpm-cifar10-32 and google/ddpm-ema-celebahq-256 at full width, and the demos, cut in depth;
# the (K1, K3, bias_shift) launches a forward, derived from the configs (K2: one for every K1 of a train, ANP or
# score step; bias_shift_backward one for every conv of those)
PUBLISHED_KERNEL_CALLS = {"DDPM-CIFAR10-32": (45, 6, 65), "DDPM-EMA-CELEBAHQ-256": (65, 6, 96),
                          "attack demo": (35, 6, 51), "score demo": (35, 6, 50)}
CIFAR_FAKE_SIZE, CHAIN_STEPS, PROFILE_CHAIN_STEPS = 512, 50, 10  # the CLI fine-tune takes 4 steps at batch 128
CELEBA_CHAIN_BATCH, CELEBA_MICRO, CELEBA_ACCUM, CELEBA_TRAIN_STEPS = 8, 4, 16, 2  # bench.py's 256 px recipe
ATTACK_STEPS, DEMO_N, DEMO_CHAIN, ANP_DEMO_STEPS = 300, 16, 100, 20
VE_STEPS, VE_N, VE_CHAIN = 50, 64, 20


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def device_ms(fn, reps: int = 20) -> float:
    return device_profile(fn, reps)[1]


def top_host_ops(host: dict, per: float, n: int = 8) -> str:
    top = sorted(host.items(), key=lambda kv: -kv[1])[:n]
    return ", ".join(f"{name} {ms / per:.3f} ms" for name, ms in top)


def empty_host_cache() -> None:
    """Release the pinned host blocks that PyTorch's caching host allocator
    keeps (``torch.accelerator.empty_host_cache`` where this PyTorch has it)."""
    release = getattr(torch.accelerator, "empty_host_cache", None) or torch._C._host_emptyCache
    release()


def profiled_kernel_counts(fn) -> tuple:
    """({kernel name: instances} that torch.profiler recorded on the card
    over one call of ``fn`` and a synchronise, the launch counters over that
    call, the chains captured in it). A profiler session at times records no
    device event at all (``utils/profiling.py``): the call is then made
    again, at most ``PROFILE_ATTEMPTS`` times."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(profiling.PROFILE_ATTEMPTS):
        first = len(segments.captures())
        ops.reset_launch_counts()
        with torch.profiler.profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        seen = {e.key: e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA}
        if seen:
            return seen, ops.launch_counts(), len(segments.captures()) - first
    check(False, f"{profiling.PROFILE_ATTEMPTS} profiler sessions in a row recorded no device event")


def breakdown(kernels: dict, per: float = 1.0) -> str:
    return profiling.format_by_class(profiling.device_time_by_class(kernels), per)


def bound_ms(n_bytes: float, n_ops: float, rate, n_exp: float = 0.0) -> tuple:
    """The least time the card could take: the largest of the bytes over the
    memory rate, the operations over the rate of ``rate`` (a dtype's tensor
    or f32 rate, or "tf32x3"), and the exponentials over the special-function
    rate; and which of them it is."""
    times = {"bytes": n_bytes / PEAK_BYTES_PER_S * 1e3, "operations": n_ops / PEAK_OPS_PER_S[rate] * 1e3,
             "exponentials": n_exp / PEAK_EXP_PER_S * 1e3}
    by = max(times, key=times.get)
    return times[by], by


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def sum_tol(ref: torch.Tensor) -> dict:
    """Tolerance of an f32 sum over many terms taken in another order:
    1e-4 of the largest reference value."""
    return dict(atol=1e-4 * ref.abs().max().item(), rtol=0.0)


def check_repeatable(what: str, first, again) -> None:
    """``first`` (a tensor or a tuple of them) the same bits as ``again()``.
    On a mismatch the differing elements and a third call are reported
    before the failure, to tell an output that changed after it was made
    from a kernel whose result varies."""
    first = (first,) if torch.is_tensor(first) else tuple(first)
    second = again()
    second = (second,) if torch.is_tensor(second) else tuple(second)
    if all(torch.equal(a, b) for a, b in zip(first, second)):
        return
    third = again()
    third = (third,) if torch.is_tensor(third) else tuple(third)
    for i, (a, b, c) in enumerate(zip(first, second, third)):
        if torch.equal(a, b):
            continue
        idx = (a != b).nonzero()
        print(f"   {what} output {i}: {idx.shape[0]} of {a.numel()} elements differ between two calls, max |d| "
              f"{max_err(a, b):.3g}, first at {idx[0].tolist()}, last at {idx[-1].tolist()}; a third call equals "
              f"the first: {torch.equal(a, c)}, the second: {torch.equal(b, c)}", flush=True)
    raise SmokeFailure(f"{what}: output differs between two calls")


def check_close(label: str, got, want, tols) -> float:
    """Every output within its tolerance; returns the largest abs error."""
    err = 0.0
    for i, (a, b, tol) in enumerate(zip(got, want, tols)):
        e = max_err(a, b)
        err = max(err, e)
        check(a.shape == b.shape and torch.allclose(a.float(), b.float(), **tol),
              f"{label} output {i}: max |kernel - reference| = {e:.3g} (tolerance {tol})")
    return err


def phase_environment() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print("card (nvidia-smi name, power.limit):")
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s) visible")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off for cuDNN convs and cuBLAS matmuls (full f32 for the f32 checks)")
    build_s = _build.build()
    print(f"kernel build: {build_s:.1f} s ({len(_build.SOURCES)} sources, one nvcc each, in parallel)")
    return smi


class KernelRecord:
    """Checks one kernel against its plain twin shape by shape and sums, over
    the main path's calls per UNet forward (or train step), the bf16 device
    times and the bound's bytes and operations."""

    def __init__(self, name: str, source: str, replaces: str, library: str, per: str = "UNet forward",
                 second: str = ""):
        self.entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces}
        self.library = library
        self.per = per
        self.second = second  # the name of a second kernel each call launches, timed apart too
        self.err = 0.0
        self.tot = dict(ms=0.0, second_ms=0.0, wall_ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0, exps=0.0)
        self.times = {}  # label -> the bf16 kernel's device ms per call

    def shape(self, label: str, mult: int, dtype, kernel, plain, library, n_bytes: float, n_ops: float,
              tols=None, n_exp: float = 0.0, time_dtype=torch.bfloat16, reps: int = 20, rate=None) -> tuple:
        """``kernel`` and ``plain`` return a tensor or a tuple of them, each
        held to its entry of ``tols`` (default ``TOL[dtype]``). Times the
        calls in ``time_dtype`` (the dtype, or a tuple of the dtypes, the
        shape's paths run in), with ``reps`` calls a window (fewer for the
        slowest shapes); the bound counts the operations at ``rate``
        (default: ``dtype``'s). Returns the kernel's outputs as a tuple."""
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        got, want = (got,) if torch.is_tensor(got) else got, (want,) if torch.is_tensor(want) else want
        e = check_close(f"{self.entry['name']} {label} {dtype} vs plain", got, want, tols or [TOL[dtype]] * len(got))
        self.err = max(self.err, e)
        if dtype not in (time_dtype if isinstance(time_dtype, tuple) else (time_dtype,)):  # the paths' dtypes only
            return got
        _, k_ms, kern, _ = device_profile(kernel, reps)
        s_ms = sum(ms for key, ms in kern.items() if self.second and self.second in key)
        k_wall = time_ms(kernel, reps=reps, repeats=5 if reps > 3 else 2)
        p_ms, l_ms = device_ms(plain, reps), device_ms(library, reps)
        b_ms, b_by = bound_ms(n_bytes, n_ops, dtype if rate is None else rate, n_exp)
        second = f" ({self.second} {s_ms:.4f} of it)" if self.second else ""
        print(f"   {label} x{mult:2d}  {str(dtype)[6:]} kernel {k_ms:.4f} ms{second} (per-call wall {k_wall:.4f})  "
              f"plain {p_ms:.4f} ms  {self.library} {l_ms:.4f} ms  bound {b_ms:.5f} ms ({b_by}; kernel/bound "
              f"{k_ms / b_ms:.2f}, kernel/{self.library} {k_ms / l_ms:.2f})  max err {e:.3g}")
        self.times[label if dtype == torch.bfloat16 else f"{label} {dtype}"] = k_ms
        for key, val in (("ms", k_ms), ("second_ms", s_ms), ("wall_ms", k_wall), ("plain_ms", p_ms),
                         ("library_ms", l_ms), ("bytes", n_bytes), ("ops", n_ops), ("exps", n_exp)):
            self.tot[key] += mult * val
        return got

    def summary(self, calls: int) -> dict:
        tot = self.tot
        b_ms, b_by = bound_ms(tot["bytes"], tot["ops"], torch.bfloat16, tot["exps"])
        second = f" ({self.second} {tot['second_ms']:.4f} of it)" if self.second else ""
        print(f"   per {self.per} (B={BATCH}, bf16, {calls} calls): kernel {tot['ms']:.4f} ms{second} "
              f"(per-call wall {tot['wall_ms']:.4f})  plain {tot['plain_ms']:.4f} ms  {self.library} "
              f"{tot['library_ms']:.4f} ms  bound {b_ms:.5f} ms ({tot['bytes'] / 1e9:.3f} GB)")
        return dict(self.entry, max_abs_err=self.err, ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=b_ms,
                    bound_by=b_by, library_ms=tot["library_ms"])


def check_k1_stats_and_repeatable(label: str, x, weight, bias) -> None:
    """K1's saved ``[B, G]`` mean/rstd against the plain ones (mean atol
    1e-6, rstd rtol 1e-5: f32 sums in another order), and its output and
    statistics the same bits over two calls, with and without statistics."""
    first = ops.groupnorm_silu_forward(x, weight, bias, GROUPS, EPS)
    mean, rstd = ops.groupnorm_stats_plain(x, GROUPS, EPS)
    check_close(f"K1 {label} {x.dtype} statistics vs plain", first[1:], (mean, rstd),
                [dict(atol=1e-6, rtol=0.0), dict(atol=0.0, rtol=1e-5)])
    check_repeatable(f"K1 {label} {x.dtype} (output and statistics)", first,
                     lambda: ops.groupnorm_silu_forward(x, weight, bias, GROUPS, EPS))
    check_repeatable(f"K1 {label} {x.dtype} (output without statistics)", first[0],
                     lambda: ops.groupnorm_silu(x, weight, bias, GROUPS, EPS))


def plan_text(x, plan=ops.groupnorm_silu_plan) -> str:
    b, h, w, c = x.shape
    p = plan(b, h * w, c, GROUPS, x.element_size(), 16)
    return (f"{p.variant}, slab {p.slab_groups} groups ({p.slab_groups * c // GROUPS * x.element_size()} B a pixel), "
            f"packs of {p.vec}, {p.threads} threads, {p.smem_bytes} B shared, {p.blocks} blocks")


def phase_groupnorm(dev, gen) -> dict:
    print(f"-- K1 groupnorm_silu vs groupnorm_silu_plain, B={BATCH}, G={GROUPS}, eps={EPS}; "
          "tolerance f32 atol 1e-5 (sums reordered), bf16 atol 1e-2 rtol 1e-2 in f32 (one bf16 ulp ~0.8%); "
          "[B, G] statistics and bitwise repeatability checked at every shape")
    rec = KernelRecord("groupnorm_silu", "baddiffusion_tpu_torch/csrc/groupnorm_silu.cu",
                       "baddiffusion_tpu/ops/groupnorm.py:135", "F.group_norm+F.silu")
    for (h, w, c), mult in GN_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            x, weight, bias = gn_inputs(dev, gen, h, w, c, dtype)
            x_nchw = x.permute(0, 3, 1, 2)  # channels_last NCHW view for the library call
            w_lib, b_lib = weight.to(dtype), bias.to(dtype)  # torch's group_norm takes them in x's dtype
            label = f"({h:2d},{w:2d},{c:4d})"
            if dtype == torch.bfloat16:
                print(f"   {label} plan: {plan_text(x)}")
            rec.shape(
                label, mult, dtype,
                lambda: ops.groupnorm_silu(x, weight, bias, GROUPS, EPS),
                lambda: ops.groupnorm_silu_plain(x, weight, bias, GROUPS, EPS),
                lambda: F.silu(F.group_norm(x_nchw, GROUPS, w_lib, b_lib, EPS)),
                n_bytes=2 * x.numel() * x.element_size() + 2 * c * 4,
                n_ops=GN_FLOPS_PER_ELEMENT * x.numel(),
            )
            check_k1_stats_and_repeatable(label, x, weight, bias)
    # the sampling path's batch, and a slab too large to stage (two walks over x): checked, and
    # the bf16 kernel's device time
    sampling_ms = 0.0
    for b, (h, w, c) in [(SAMPLE_BATCH, shape) for shape in GN_SHAPES] + [(2, (128, 128, 128))]:
        for dtype in (torch.float32, torch.bfloat16):
            x, weight, bias = gn_inputs(dev, gen, h, w, c, dtype, batch=b)
            label = f"B={b} ({h},{w},{c})"
            got = ops.groupnorm_silu(x, weight, bias, GROUPS, EPS)
            want = ops.groupnorm_silu_plain(x, weight, bias, GROUPS, EPS)
            rec.err = max(rec.err, check_close(f"K1 {label} {dtype} vs plain", (got,), (want,), [TOL[dtype]]))
            check_k1_stats_and_repeatable(label, x, weight, bias)
        k_ms = device_ms(lambda: ops.groupnorm_silu(x, weight, bias, GROUPS, EPS))
        sampling_ms += GN_SHAPES.get((h, w, c), 0) * k_ms if b == SAMPLE_BATCH else 0.0
        print(f"   {label} f32 and bf16 match the plain version, statistics and repeatability checked; bf16 kernel "
              f"{k_ms:.4f} ms; plan (bf16): {plan_text(x)}")
    print(f"   per UNet forward (B={SAMPLE_BATCH}, bf16, {GN_PER_FORWARD} calls): kernel {sampling_ms:.4f} ms")
    print("   phase 9's and 10's shapes (the LDM UNet at B=16 in bf16, the VQ-VAE's 256 px stage in f32, "
          "google/ddpm-ema-celebahq-256's at micro-batch 4 in bf16):")
    for (b, h, w, c), time_dtype in GN_LATENT_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            x, weight, bias = gn_inputs(dev, gen, h, w, c, dtype, batch=b)
            x_nchw = x.permute(0, 3, 1, 2)
            w_lib, b_lib = weight.to(dtype), bias.to(dtype)
            label = f"B={b} ({h},{w},{c})"
            if dtype == time_dtype:
                print(f"   {label} plan ({str(dtype)[6:]}): {plan_text(x)}")
            rec.shape(
                label, 0, dtype,
                lambda: ops.groupnorm_silu(x, weight, bias, GROUPS, EPS),
                lambda: ops.groupnorm_silu_plain(x, weight, bias, GROUPS, EPS),
                lambda: F.silu(F.group_norm(x_nchw, GROUPS, w_lib, b_lib, EPS)),
                n_bytes=2 * x.numel() * x.element_size() + 2 * c * 4,
                n_ops=GN_FLOPS_PER_ELEMENT * x.numel(), time_dtype=time_dtype,
            )
            check_k1_stats_and_repeatable(label, x, weight, bias)
            del x, x_nchw
    return rec.summary(GN_PER_FORWARD)


def gn_inputs(dev, gen, h: int, w: int, c: int, dtype, batch: int = BATCH) -> tuple:
    """x ``[batch, h, w, c]`` in ``dtype``; γ/β f32, as the kernels take them."""
    x = torch.randn(batch, h, w, c, generator=gen, device=dev).to(dtype)
    weight = torch.rand(c, generator=gen, device=dev) + 0.5
    bias = 0.1 * torch.randn(c, generator=gen, device=dev)
    return x, weight, bias


def check_k2_autograd_and_repeatable(label: str, x, weight, bias, ct, got) -> None:
    """K2's outputs ``got`` against autograd through ``groupnorm_silu_plain``,
    and dx, dγ, dβ the same bits on a second call."""
    _, mean, rstd = ops.groupnorm_silu_forward(x, weight, bias, GROUPS, EPS)
    check_repeatable(f"K2 {label} {x.dtype} (dx, dγ, dβ)", got,
                     lambda: ops.groupnorm_silu_backward(x, weight, bias, mean, rstd, ct, GROUPS))
    xr, wr, br = (a.detach().clone().requires_grad_() for a in (x, weight, bias))
    auto = torch.autograd.grad(ops.groupnorm_silu_plain(xr, wr, br, GROUPS, EPS), (xr, wr, br), ct)
    dx_tol = (dict(atol=1e-4 * auto[0].abs().max().item(), rtol=1e-4) if x.dtype == torch.float32
              else dict(atol=2e-2, rtol=1e-2))
    check_close(f"K2 {label} {x.dtype} vs autograd", got, auto, [dx_tol, sum_tol(auto[1]), sum_tol(auto[2])])


def phase_groupnorm_backward(dev, gen) -> dict:
    print(f"-- K2 groupnorm_silu_backward vs groupnorm_silu_backward_plain on K1's saved statistics, B={BATCH}, "
          f"G={GROUPS}; tolerance dx f32 atol 1e-5, bf16 atol 1e-2 rtol 1e-2 in f32; dγ/dβ (f32 sums over B·H·W in "
          "another order) atol 1e-4·max|ref|. Against autograd through groupnorm_silu_plain: dx f32 atol "
          "1e-4·max|dx| rtol 1e-4 (other arithmetic), bf16 atol 2e-2 rtol 1e-2 (both round to bf16 once); "
          "dγ/dβ as above. dx, dγ and dβ of two calls must be bitwise equal. Each call is two kernels: "
          "groupnorm_silu_bwd_kernel, then sum_rows_kernel (dγ/dβ summed over B), timed apart too.")
    rec = KernelRecord("groupnorm_silu_backward", "baddiffusion_tpu_torch/csrc/groupnorm_silu_bwd.cu",
                       "baddiffusion_tpu/ops/groupnorm.py:164", "autograd.grad(F.silu(F.group_norm))",
                       per="train step", second="sum_rows_kernel")
    for (h, w, c), mult in GN_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            k2_shape(rec, dev, gen, BATCH, h, w, c, dtype, f"({h:2d},{w:2d},{c:4d})", mult, torch.bfloat16)
    # a slab too large to stage (two walks over x and the cotangent): checked, and the bf16 kernel's device time
    b, (h, w, c) = 2, (128, 128, 128)
    label = f"B={b} ({h},{w},{c})"
    for dtype in (torch.float32, torch.bfloat16):
        x, weight, bias = gn_inputs(dev, gen, h, w, c, dtype, batch=b)
        ct = torch.randn(b, h, w, c, generator=gen, device=dev).to(dtype)
        _, mean, rstd = ops.groupnorm_silu_forward(x, weight, bias, GROUPS, EPS)
        got = ops.groupnorm_silu_backward(x, weight, bias, mean, rstd, ct, GROUPS)
        ref = ops.groupnorm_silu_backward_plain(x, weight, bias, mean, rstd, ct, GROUPS)
        rec.err = max(rec.err, check_close(f"K2 {label} {dtype} vs plain", got, ref,
                                           [TOL[dtype], sum_tol(ref[1]), sum_tol(ref[2])]))
        check_k2_autograd_and_repeatable(label, x, weight, bias, ct, got)
    k_ms = device_ms(lambda: ops.groupnorm_silu_backward(x, weight, bias, mean, rstd, ct, GROUPS))
    print(f"   {label} f32 and bf16 match the plain version and autograd, repeatability checked; bf16 kernel "
          f"{k_ms:.4f} ms; plan (bf16): {plan_text(x, ops.groupnorm_silu_backward_plan)}")
    del x, ct, got, ref
    print("   phase 9's and 10's shapes (the LDM UNet at B=16 in bf16, the VQ-VAE's 256 px stage in f32, "
          "google/ddpm-ema-celebahq-256's at micro-batch 4 in bf16):")
    for (b, h, w, c), time_dtype in GN_LATENT_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            k2_shape(rec, dev, gen, b, h, w, c, dtype, f"B={b} ({h},{w},{c})", 0, time_dtype)
    return rec.summary(GN_PER_FORWARD)


def k2_shape(rec, dev, gen, b: int, h: int, w: int, c: int, dtype, label: str, mult: int, time_dtype) -> None:
    """K2 at one shape: against its plain twin (timed in ``time_dtype``),
    autograd and itself over two calls."""
    x, weight, bias = gn_inputs(dev, gen, h, w, c, dtype, batch=b)
    ct = torch.randn(b, h, w, c, generator=gen, device=dev).to(dtype)
    _, mean, rstd = ops.groupnorm_silu_forward(x, weight, bias, GROUPS, EPS)
    if dtype == time_dtype:
        print(f"   {label} plan ({str(dtype)[6:]}): {plan_text(x, ops.groupnorm_silu_backward_plan)}")

    def kernel():
        return ops.groupnorm_silu_backward(x, weight, bias, mean, rstd, ct, GROUPS)

    def plain():
        return ops.groupnorm_silu_backward_plain(x, weight, bias, mean, rstd, ct, GROUPS)

    # the library call: autograd through torch's group_norm + silu, graph retained
    xl = x.clone().requires_grad_()
    wl, bl = (p.to(dtype).requires_grad_() for p in (weight, bias))
    y_lib = F.silu(F.group_norm(xl.permute(0, 3, 1, 2), GROUPS, wl, bl, EPS))
    ct_nchw = ct.permute(0, 3, 1, 2)
    ref = plain()
    got = rec.shape(
        label, mult, dtype, kernel, plain,
        lambda: torch.autograd.grad(y_lib, (xl, wl, bl), ct_nchw, retain_graph=True),
        n_bytes=3 * x.numel() * x.element_size() + 4 * c * 4 + 2 * b * GROUPS * 4,
        n_ops=GN_BWD_FLOPS_PER_ELEMENT * x.numel(),
        tols=[TOL[dtype], sum_tol(ref[1]), sum_tol(ref[2])], time_dtype=time_dtype,
    )
    check_k2_autograd_and_repeatable(label, x, weight, bias, ct, got)


# the conv bias shift at the cells' shapes: (B, C, H, W, dtype, with the time-embedding row); the first is
# google/ddpm-ema-celebahq-256's 256² level at B=16, the shape PERF.md's kernel table times
SHIFT_SHAPES = [(16, 128, 256, 256, torch.bfloat16, True), (16, 128, 256, 256, torch.bfloat16, False),
                (16, 512, 8, 8, torch.bfloat16, True), (16, 3, 256, 256, torch.bfloat16, False),
                (256, 128, 32, 32, torch.float32, True)]


def phase_bias_shift(dev, gen) -> dict:
    print("-- the conv bias shift (bias_shift_fwd_kernel; bias_shift_bwd_kernel + bias_shift_fold_kernel) vs its "
          "plain twin: the forward bitwise (the same f32 sum, one rounding), in place; the gradients f32 sums "
          "in another order, atol 1e-4·max|ref| (the row's also one bf16 rounding) and bitwise over two calls; "
          "library: the aten passes it replaces (the bias add_ after cuDNN's conv, the time embedding's add; the "
          "gradients' sums); bound: bytes at 3.35 TB/s")
    rec = KernelRecord("bias_shift", "baddiffusion_tpu_torch/csrc/bias_shift.cu",
                       "none (XLA fuses the bias into the conv); aten::add_/add and aten::sum", "aten",
                       per="256² conv at B=16")
    for b, c, h, w, dtype, with_row in SHIFT_SHAPES:
        y0 = torch.randn(b, c, h, w, generator=gen, device=dev).to(dtype)
        y0 = y0.contiguous(memory_format=torch.channels_last)
        bias = 0.02 * torch.randn(c, generator=gen, device=dev)
        row = torch.randn(b, c, generator=gen, device=dev).to(dtype) if with_row else None
        yk, yp, yl = y0.clone(), y0.clone(), y0.clone()
        b_lib = bias.to(dtype)[None, :, None, None]
        r_lib = None if row is None else row[:, :, None, None]
        label = f"[{b},{c},{h},{w}]{' +row' if with_row else ''}"
        print(f"   {label} plan: {ops.bias_shift_plan(b, h * w, c, y0.element_size(), 16)}")
        rec.shape(
            f"fwd {label}", int(label == "[16,128,256,256] +row"), dtype,
            lambda: ops.bias_shift(yk, bias, row), lambda: ops.bias_shift_plain(yp, bias, row),
            lambda: yl.add_(b_lib) if r_lib is None else yl.add_(b_lib) + r_lib,
            n_bytes=2 * y0.numel() * y0.element_size(), n_ops=2 * y0.numel(), tols=[dict(atol=0.0, rtol=0.0)],
            time_dtype=dtype,
        )
        t = y0.clone()
        check(ops.bias_shift(t, bias, row) is t and torch.equal(t, ops.bias_shift_plain(y0.clone(), bias, row)),
              f"bias_shift {label}: not in place or not the twin's bits")
        g = y0
        row_dtype = dtype if with_row else None
        ref = ops.bias_shift_backward_plain(g, row_dtype)
        tols = [sum_tol(ref[0])] + ([dict(atol=1e-4 * ref[1].abs().max().item(), rtol=2 ** -7)] if with_row else [])
        got = rec.shape(
            f"bwd {label}", 0, dtype,
            lambda: ops.bias_shift_backward(g, row_dtype)[:1 + with_row],
            lambda: ops.bias_shift_backward_plain(g, row_dtype)[:1 + with_row],
            lambda: (g.sum(dim=(0, 2, 3)), g.sum(dim=(2, 3))) if with_row else g.sum(dim=(0, 2, 3)),
            n_bytes=g.numel() * g.element_size(), n_ops=g.numel(), tols=tols, time_dtype=dtype,
        )
        check_repeatable(f"bias_shift backward {label}", got,
                         lambda: ops.bias_shift_backward(g, row_dtype)[:1 + with_row])
        del y0, yk, yp, yl, g, t
    tot = rec.tot
    b_ms, b_by = bound_ms(tot["bytes"], tot["ops"], torch.bfloat16)
    print(f"   per 256² conv of google/ddpm-ema-celebahq-256 at B=16 (bf16, its time-embedding row): kernel "
          f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, aten {tot['library_ms']:.4f} ms, bound {b_ms:.5f} ms")
    return dict(rec.entry, max_abs_err=rec.err, ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                library_ms=tot["library_ms"])


VQ_SHAPE = (256 * 64 * 64, 8192, 3)  # the LDM measure's decode: 256 latents of 64x64 vectors of 3, 8192 codes
VQ_ROWS = 1 << 16  # vectors a block of the twin's [rows, K] distances (2 GiB in f32)
VQ_TIE = 2.0 ** -18  # a near tie, as the benchmark's: within f32 rounding of ‖z‖² + ‖e‖²
VQ_OPS_PER_S = 495e12  # the benchmark's f32 rate (TF32), at which its yardstick counts 2·D·K a vector


def vq_blocks(fn, z, codebook):
    """``fn`` over ``VQ_ROWS`` vectors of ``z`` at a time, the results joined."""
    return torch.cat([fn(z[r:r + VQ_ROWS], codebook) for r in range(0, z.shape[0], VQ_ROWS)])


def phase_vq_nearest(dev, gen) -> dict:
    print("-- the VQ nearest-code search (vq_nearest_kernel) vs its plain twin (the expanded-L2 argmin, in row "
          "blocks of 65536 vectors) at the LDM measure's decode: 1,048,576 vectors of 3 against 8192 codes; a code "
          "may differ from the twin's only in a near tie (the twin's distances within 2**-18 of ‖z‖² + ‖e‖²), z_q "
          "is codebook[idx] bitwise, both bitwise over two calls, the peak under 1 GiB beyond the outputs; "
          "library: torch.cdist + argmin in the same row blocks; bound: 2·D·K operations a vector at 495 TFLOP/s")
    n, k, d = VQ_SHAPE
    z = torch.randn(n, d, generator=gen, device=dev)
    codebook = torch.randn(k, d, generator=gen, device=dev)
    print(f"   plan: {ops.vq_nearest_plan(n, k, d)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    idx, zq = ops.vq_nearest(z, codebook)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base - idx.numel() * idx.element_size() - zq.numel() * 4
    check(extra < 1 << 30, f"vq_nearest: {extra} bytes allocated beyond its outputs")
    check(torch.equal(zq, codebook[idx]), "vq_nearest: z_q is not codebook[idx] bit for bit")
    norms = codebook.square().sum(dim=1)
    differ = ties = 0
    err = 0.0
    for r in range(0, n, VQ_ROWS):
        zb, got = z[r:r + VQ_ROWS], idx[r:r + VQ_ROWS]
        want = ops.vq_nearest_plain(zb, codebook)[0]
        dist = zb.square().sum(dim=1, keepdim=True) + norms[None, :] - 2.0 * zb @ codebook.T
        over = dist.gather(1, got[:, None])[:, 0] - dist.gather(1, want[:, None])[:, 0]
        near = over.abs() <= VQ_TIE * (zb.square().sum(dim=1) + norms[got])
        off = got != want
        differ += int((off & ~near).sum())
        ties += int((off & near).sum())
        err = max(err, over.abs().max().item())
        del dist
    print(f"   codes: {ties} near ties of {n} differ from the twin's, {differ} beyond; largest distance gap {err:.3g}")
    check(differ == 0, f"vq_nearest: {differ} of {n} codes differ from the twin's beyond a near tie")
    check_repeatable("vq_nearest", (idx, zq), lambda: ops.vq_nearest(z, codebook))
    _, k_ms, _, _ = device_profile(lambda: ops.vq_nearest(z, codebook), 20)
    p_ms = device_ms(lambda: vq_blocks(lambda a, b: ops.vq_nearest_plain(a, b)[0], z, codebook), reps=3)
    l_ms = device_ms(lambda: vq_blocks(lambda a, b: torch.cdist(a, b).argmin(dim=1), z, codebook), reps=3)
    b_ms = 2 * d * k * n / VQ_OPS_PER_S * 1e3
    print(f"   kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  cdist+argmin {l_ms:.4f} ms  bound {b_ms:.5f} ms "
          f"(operations; kernel/bound {k_ms / b_ms:.2f}, {100 * b_ms / k_ms:.2f}% of it)")
    del z, codebook, idx, zq
    return dict(name="vq_nearest", route="cuda", source="baddiffusion_tpu_torch/csrc/vq_nearest.cu",
                replaces="none (XLA builds the whole [N, K] expanded-L2 matrix, then its argmin)",
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by="operations", library_ms=l_ms)


def attn_rate(plan, dtype):
    """The rate K3's bound counts a plan's products at: the tf32x3 and
    tf32x3_wg plans run f32 as three TF32 tensor-core products; the others
    at their dtype's."""
    return "tf32x3" if plan.variant.startswith("tf32x3") else dtype


def phase_attention(dev, gen) -> dict:
    print("-- K3 attention vs attention_plain; tolerance f32 atol 1e-5 (sums reordered), bf16 atol 1e-2 rtol 1e-2 "
          "in f32 (one bf16 ulp ~0.8%; absorbs the tiled and wide variants' bf16 probabilities); output bitwise equal "
          "over two calls at every shape; bound: the largest of bytes, 4·T²·D products a head over the tensor rate "
          "(the tf32x3 plan: three TF32 products, 495/3 TFLOP/s; packed: the f32 or bf16 rate) and T² exponentials "
          "a head over the special-function rate")
    rec = KernelRecord("attention", "baddiffusion_tpu_torch/csrc/attention.cu",
                       "baddiffusion_tpu/ops/attention.py:42", "sdpa")
    for (b, h, t, d), mult in ATTN_SHAPES.items():
        scale = 1.0 / d**0.5
        label = f"[{b},{h},{t},{d}]"
        for dtype in (torch.float32, torch.bfloat16):
            plan = ops.attention_plan(b * h, t, d, dtype)
            print(f"   {label} {str(dtype)[6:]} plan: {plan}")
            q, k, v = (torch.randn(b, h, t, d, generator=gen, device=dev).to(dtype) for _ in range(3))
            (first,) = rec.shape(
                label, mult, dtype,
                lambda: ops.attention(q, k, v, scale),
                lambda: ops.attention_plain(q, k, v, scale),
                lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                n_bytes=4 * q.numel() * q.element_size(),
                n_ops=4 * b * h * t * t * d,  # the q·k and p·v products
                n_exp=b * h * t * t,  # one exponential a score
                time_dtype=(torch.bfloat16, torch.float32) if (b, h, t, d) in ATTN_F32_TIMED else torch.bfloat16,
                rate=attn_rate(plan, dtype),
            )
            check_repeatable(f"K3 {label} {dtype}", first, lambda: ops.attention(q, k, v, scale))
    sampling_ms = sum(mult * rec.times[f"[{b},{h},{t},{d}]"] for (b, h, t, d), mult in ATTN_SAMPLING.items())
    print(f"   per UNet forward (B={SAMPLE_BATCH}, bf16, {sum(ATTN_SAMPLING.values())} calls): kernel "
          f"{sampling_ms:.4f} ms")
    print("   phase 9's shapes (the VQ-VAE's T = 4096 head, the LDM UNet's three resolutions and NCSN++ timed in both "
          "dtypes, the VQ-VAE's 3 calls a window; the rest bf16):")
    for (b, h, t, d), time_dtype in ATTN_LATENT_SHAPES.items():
        scale = 1.0 / d**0.5
        label = f"[{b},{h},{t},{d}]"
        for dtype in (torch.float32, torch.bfloat16):
            plan = ops.attention_plan(b * h, t, d, dtype)
            print(f"   {label} {str(dtype)[6:]} plan: {plan}")
            q, k, v = (torch.randn(b, h, t, d, generator=gen, device=dev).to(dtype) for _ in range(3))
            (first,) = rec.shape(
                label, 0, dtype,
                lambda: ops.attention(q, k, v, scale),
                lambda: ops.attention_plain(q, k, v, scale),
                lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                n_bytes=4 * q.numel() * q.element_size(), n_ops=4 * b * h * t * t * d, n_exp=b * h * t * t,
                time_dtype=dtype if time_dtype is None else time_dtype, reps=3 if t == 4096 else 20,
                rate=attn_rate(plan, dtype),
            )
            check_repeatable(f"K3 {label} {dtype}", first, lambda: ops.attention(q, k, v, scale))
            del q, k, v, first
    return rec.summary(ATTN_PER_FORWARD)


def phase_slice(dev, smi: str) -> tuple:
    """Check the slice against the CPU, drive the main path (1000-step
    sampling, clean and backdoor) with the launch counters set to 0 just
    before it, then profile it. Returns (UNet forwards of the main path,
    the launch counts read just after it)."""
    print(f"-- the slice: scratch UNet {DEFAULT_SCRATCH_CONFIG.block_out_channels} at 32 px, seeded weights")
    unet = UNet2DModel(DEFAULT_SCRATCH_CONFIG, generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in unet.parameters())
    check(n_params == 113_673_219, f"scratch UNet has {n_params} parameters")
    os.makedirs(TMP_BASE, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=TMP_BASE) as tmp:
        DiffusionPipeline(unet, DDPMScheduler(DDPMConfig())).save_pretrained(tmp)
        pipe = DiffusionPipeline.from_pretrained(tmp)
    os.rmdir(TMP_BASE)
    sd_a, sd_b = unet.state_dict(), pipe.unet.state_dict()
    check(sd_a.keys() == sd_b.keys() and all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a),
          "weights changed through save_pretrained/from_pretrained")
    print(f"   {n_params} parameters; save_pretrained/from_pretrained round trip exact")

    # f32 forward on the card (kernels) vs the same weights on the CPU (plain path)
    cpu_unet = UNet2DModel(DEFAULT_SCRATCH_CONFIG, device="cpu")
    cpu_unet.load_state_dict(pipe.unet.state_dict())
    gen_cpu = torch.Generator().manual_seed(1)
    x = torch.randn(2, 32, 32, 3, generator=gen_cpu)
    t = torch.tensor([10, 900])
    with torch.no_grad():
        y_card = pipe.unet(x.to(dev), t.to(dev)).cpu()
        y_cpu = cpu_unet(x, t)
    scale = y_cpu.abs().max().item()
    e = max_err(y_card, y_cpu)
    check(torch.allclose(y_card, y_cpu, rtol=1e-3, atol=1e-3 * scale),
          f"f32 UNet forward card vs CPU: max err {e:.3g} (|y| max {scale:.3g})")
    print(f"   f32 forward B=2, card vs CPU plain path: max err {e:.3g}, |y| max {scale:.3g} "
          "(rtol 1e-3, atol 1e-3*max|y|)")

    # a short f32 chain with the same init and noise on both
    noise = [torch.randn(2, 32, 32, 3, generator=gen_cpu) for _ in range(10)]
    cpu_pipe = DiffusionPipeline(cpu_unet, DDPMScheduler(DDPMConfig()), device="cpu")
    ref = cpu_pipe(init=x, num_inference_steps=10, noise_source=noise.__getitem__).images
    got = pipe(init=x, num_inference_steps=10, noise_source=noise.__getitem__).images
    e = float(np.abs(got - ref).max())
    check(e <= 1e-3, f"10-step f32 chain card vs CPU: max image err {e:.3g}")
    print(f"   10-step f32 chain B=2, card vs CPU plain path: max image err {e:.3g} (atol 1e-3)")

    # the main path: 1000-step bf16 sampling, clean and backdoor, counted
    pipe.compute_dtype = torch.bfloat16
    gen = torch.Generator(dev).manual_seed(2)
    noise0 = torch.randn(SAMPLE_BATCH, 32, 32, 3, generator=gen, device=dev)
    trigger = torch.from_numpy(Backdoor().get_trigger("BOX_14", 3, 32)).to(dev)
    forwards = [0]

    def count_forward(module, args):
        if isinstance(module, UNet2DModel) and args[0].is_cuda:
            forwards[0] += 1

    hook = torch.nn.modules.module.register_module_forward_pre_hook(count_forward)
    ops.reset_launch_counts()
    try:
        pipe(init=noise0, generator=gen, num_inference_steps=2)  # warm-up: first bf16 calls set up cuDNN/cuBLAS
        for name, init, movie in (("clean", noise0, False), ("backdoor", noise0 + trigger[None], True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pipe(init=init, generator=gen, num_inference_steps=SAMPLE_STEPS, save_every_step=movie)
            dt = time.perf_counter() - t0
            imgs = out.images
            check(imgs.shape == (SAMPLE_BATCH, 32, 32, 3), f"{name} images shape {imgs.shape}")
            check(bool(np.isfinite(imgs).all()) and imgs.min() >= 0.0 and imgs.max() <= 1.0,
                  f"{name} images not finite in [0, 1]")
            if movie:
                check(out.movie.shape == (50, SAMPLE_BATCH, 32, 32, 3), f"movie shape {out.movie.shape}")
                check(bool(np.array_equal(out.movie[-1], imgs)), "movie's last frame is not the final image")
            print(f"   {SAMPLE_STEPS}-step bf16 DDPM sampling, {name}{' with movie' if movie else ''}, "
                  f"B={SAMPLE_BATCH}: {dt:.2f} s, {SAMPLE_BATCH / dt:.3f} imgs/s, "
                  f"{dt / SAMPLE_STEPS * 1e3:.3f} ms/step, mean pixel {imgs.mean():.4f} on {smi}")
    finally:
        hook.remove()
    counts = ops.launch_counts()

    # where the time goes: a profiled bf16 chain window, and bf16 forwards
    unet_bf16 = pipe.unet.compute_copy(torch.bfloat16)
    bf16_pipe = DiffusionPipeline(unet_bf16, pipe.scheduler)
    wall, dev_ms, kern, host = device_profile(
        lambda: bf16_pipe(init=noise0, generator=gen, num_inference_steps=PROFILE_STEPS), reps=1)
    print(f"   profiled {PROFILE_STEPS}-step bf16 chain B={SAMPLE_BATCH}: {wall / PROFILE_STEPS:.3f} ms/step wall, "
          f"{dev_ms / PROFILE_STEPS:.3f} ms/step device kernels, device idle {100 * (1 - dev_ms / wall):.1f}%")
    print(f"     device time per step: {breakdown(kern, PROFILE_STEPS)}")
    print(f"     host self time per step (profiled): all ops {sum(host.values()) / PROFILE_STEPS:.3f} ms; "
          f"top: {top_host_ops(host, PROFILE_STEPS)}")
    for b in (SAMPLE_BATCH, BATCH):
        xb = torch.randn(b, 32, 32, 3, generator=gen, device=dev)
        tb = torch.randint(0, 1000, (b,), generator=gen, device=dev)
        with torch.inference_mode():
            ms = time_ms(lambda: unet_bf16(xb, tb), reps=10, repeats=3)
            wall, dev_ms, kern, _ = device_profile(lambda: unet_bf16(xb, tb), reps=3)
        print(f"   bf16 UNet forward B={b}: {ms:.3f} ms wall (CUDA events), {dev_ms:.3f} ms device kernels, "
              f"device idle {100 * (1 - dev_ms / ms):.1f}% on {smi}")
        print(f"     device time per forward: {breakdown(kern)}")
    return forwards[0], counts


def zoo_scheduler(name: str) -> tuple:
    """(scheduler, pipeline kind) of a zoo name: the factory's, or Karras-VE's defaults."""
    if name == "KARRAS-VE":
        return KarrasVeScheduler(), "karras"
    make, kind = factory._sched_spec(name)
    return make(factory.DiffuserModelSched.CLIP_SAMPLE_DEFAULT), kind


def zoo_steps(name: str, kind: str) -> int:
    return ZOO_SDE_STEPS if kind == "sde" else factory.PIPELINE_DEFAULT_STEPS[kind]


def zoo_forwards(scheduler, kind: str, n: int) -> tuple:
    """(scheduler steps, UNet forwards) of an n-step chain, as each engine is
    designed: one forward a step for the generic chain (len(timesteps):
    n, PNDM's PRK and PLMS steps, Heun's 2n - 1); SDE-VE correct_steps + 1
    a step; Karras-VE two a step, one on the last (σ_prev = 0)."""
    steps = len(scheduler.set_timesteps(scheduler.create_state(), n).timesteps)
    if kind == "sde":
        return steps, steps * (scheduler.config.correct_steps + 1)
    if kind == "karras":
        return steps, 2 * steps - 1
    return steps, steps


def standin(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The tests' deterministic stand-in denoiser, per sample."""
    return 0.1 * x + 0.05 * torch.sin(t.float() / 100.0).view(-1, 1, 1, 1)


def phase_zoo(dev, smi: str) -> tuple:
    """Phase 7: the zoo's scheduler arithmetic and the f32 UNet chains on the
    card against the CPU, then every chain on the full-width UNet in bf16 at
    B=16 with the launch counters set to 0 just before and read just after,
    each step under the sync guard; then the numbers. Returns (UNet
    forwards, the launch counts)."""
    print(f"-- the sampler zoo: {len(ZOO_NAMES)} chains ({', '.join(ZOO_NAMES)})")
    phase_t0 = time.perf_counter()
    gen_cpu = torch.Generator().manual_seed(70)

    # (a) the scheduler arithmetic: stand-in chains, card against CPU, same init and noise
    init = torch.randn(ZOO_STANDIN_SHAPE, generator=gen_cpu)
    noise = [torch.randn(ZOO_STANDIN_SHAPE, generator=gen_cpu) for _ in range(4 * ZOO_STANDIN_STEPS)]
    noise_card = [z.to(dev) for z in noise]
    worst = 0.0
    for name in ZOO_NAMES:
        out = {}
        for device, source in (("cpu", noise), ("cuda", noise_card)):
            scheduler, _ = zoo_scheduler(name)
            state = scheduler.set_timesteps(scheduler.create_state(), ZOO_STANDIN_STEPS)
            out[device], _ = sample_chain(scheduler, state, standin, init.to(device), noise_source=source.__getitem__)
        ref, got = out["cpu"], out["cuda"].cpu()
        scale = ref.abs().max().item()
        e = max_err(got, ref)
        check(bool(torch.isfinite(got).all()) and e <= 1e-4 * scale + 1e-4,
              f"zoo {name} stand-in chain card vs CPU: max err {e:.3g} (max|x| {scale:.3g})")
        worst = max(worst, e / (1e-4 * scale + 1e-4))
        print(f"   (a) {name:24s} stand-in {ZOO_STANDIN_STEPS} steps {list(ZOO_STANDIN_SHAPE)} f32, card vs CPU: "
              f"max err {e:.3g}, max|x| {scale:.4g}")
    print(f"   (a) every stand-in chain within max err <= 1e-4*max|x| + 1e-4 (worst at {worst:.3f} of its bound); "
          f"{time.perf_counter() - phase_t0:.1f} s")

    # (b) the full-width UNet in f32: card against CPU
    unet = UNet2DModel(DEFAULT_SCRATCH_CONFIG, generator=torch.Generator().manual_seed(0))
    cpu_unet = UNet2DModel(DEFAULT_SCRATCH_CONFIG, device="cpu")
    cpu_unet.load_state_dict(unet.state_dict())
    x = torch.randn(2, 32, 32, 3, generator=gen_cpu)
    for name in ZOO_F32_CHAINS:
        out = {}
        for device, model in (("cpu", cpu_unet), ("cuda", unet)):
            scheduler, kind = zoo_scheduler(name)
            pipe = factory._make_get_pipeline(model, kind, False)(scheduler, device=device)
            out[device] = pipe(init=x, num_inference_steps=ZOO_F32_STEPS, output_type="pt").sample.cpu()
        ref, got = out["cpu"], out["cuda"]
        scale = ref.abs().max().item()
        e = max_err(got, ref)
        check(torch.allclose(got, ref, rtol=1e-3, atol=1e-3 * scale),
              f"zoo {name} f32 UNet chain card vs CPU: max err {e:.3g} (max|y| {scale:.3g})")
        print(f"   (b) {name:24s} full-width UNet f32, {ZOO_F32_STEPS} steps B=2, card vs CPU: max err {e:.3g}, "
              f"max|y| {scale:.4g} (rtol 1e-3, atol 1e-3*max|y|)")
    del cpu_unet
    print(f"   (b) done at {time.perf_counter() - phase_t0:.1f} s into the phase")

    # (c) the path: bf16 chains at B=16 from noise + trigger, counted, each under the sync guard
    gen = torch.Generator(dev).manual_seed(71)
    trigger = torch.from_numpy(Backdoor().get_trigger("BOX_14", 3, 32)).to(dev)
    init = torch.randn(SAMPLE_BATCH, 32, 32, 3, generator=gen, device=dev) + trigger[None]
    forwards = [0]

    def count_forward(module, args):
        if isinstance(module, UNet2DModel) and args[0].is_cuda:
            forwards[0] += 1

    def pipeline(name):
        scheduler, kind = zoo_scheduler(name)
        return factory._make_get_pipeline(unet, kind, False)(scheduler, compute_dtype=torch.bfloat16), kind

    pipeline(_S.DDIM_SCHED)[0](init=init, generator=gen, num_inference_steps=2)  # warm-up: bf16 algorithms
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # the guard is live: it refuses a read-back
    try:
        init.sum().item()
        caught = False
    except RuntimeError:
        caught = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(caught, "zoo: torch.cuda.set_sync_debug_mode('error') let a .item() through")
    rows = []
    hook = torch.nn.modules.module.register_module_forward_pre_hook(count_forward)
    ops.reset_launch_counts()
    try:
        for name in ZOO_NAMES:
            pipe, kind = pipeline(name)
            n = zoo_steps(name, kind)
            steps, want = zoo_forwards(pipe.scheduler, kind, n)
            before = forwards[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = pipe(init=init, generator=gen, num_inference_steps=n, output_type="pt")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got = forwards[0] - before
            peak = out.sample.abs().max().item()
            images = out.images
            check(got == want, f"zoo {name}: {got} UNet forwards, designed {want}")
            check(bool(torch.isfinite(out.sample).all()), f"zoo {name}: the sample before the clip is not finite")
            check(images.shape == (SAMPLE_BATCH, 32, 32, 3) and images.min().item() >= 0.0
                  and images.max().item() <= 1.0, f"zoo {name}: images not in [0, 1]")
            rows.append((name, n, steps, got, dt))
            print(f"   (c) {name:24s} {n:3d} steps ({steps} scheduler steps), {got:3d} forwards, bf16 B={SAMPLE_BATCH}: "
                  f"{dt:.3f} s, {dt / steps * 1e3:.3f} ms/step, {dt / got * 1e3:.3f} ms/forward, "
                  f"{SAMPLE_BATCH / dt:.3f} imgs/s; max|x| before the clip {peak:.4g}, mean pixel "
                  f"{images.mean().item():.4f}; no step synchronised")

        # (d) a profiled DPM-Solver++ O2 chain, and the same chain at B=128
        pipe, kind = pipeline(_S.DPM_SOLVER_PP_O2_SCHED)
        n = zoo_steps(_S.DPM_SOLVER_PP_O2_SCHED, kind)
        wall, dev_ms, kern, host = device_profile(
            lambda: pipe(init=init, generator=gen, num_inference_steps=n, output_type="pt"), reps=1)
        print(f"   (d) profiled DPM-Solver++ O2 chain, {n} steps bf16 B={SAMPLE_BATCH}: {wall / n:.3f} ms/step wall, "
              f"{dev_ms / n:.3f} ms/step device kernels, device idle {100 * (1 - dev_ms / wall):.1f}% on {smi}")
        print(f"     device time per step: {breakdown(kern, n)}")
        print(f"     host self time per step (profiled): all ops {sum(host.values()) / n:.3f} ms; "
              f"top: {top_host_ops(host, n)}")
        big = torch.randn(BATCH, 32, 32, 3, generator=gen, device=dev) + trigger[None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe(init=big, generator=gen, num_inference_steps=n, output_type="pt")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(bool(torch.isfinite(out.sample).all()), "zoo DPM-Solver++ O2 at B=128: sample not finite")
        print(f"   (d) DPM-Solver++ O2 {n} steps bf16 B={BATCH}: {dt:.3f} s, {dt / n * 1e3:.3f} ms/step, "
              f"{BATCH / dt:.2f} imgs/s on {smi}")
    finally:
        hook.remove()
    counts = ops.launch_counts()
    total = sum(r[3] for r in rows)
    print(f"   (c) {len(rows)} chains, {total} forwards in {sum(r[4] for r in rows):.2f} s; phase 7 took "
          f"{time.perf_counter() - phase_t0:.1f} s on {smi}")
    return forwards[0], counts


def seeded_scratch_unet(device, dtype=torch.float32) -> UNet2DModel:
    """The full-width scratch UNet from seed 0, with its biases and GroupNorm
    affines moved off 0 and 1 (from seed 1) so their gradients count."""
    unet = UNet2DModel(DEFAULT_SCRATCH_CONFIG, device=device, generator=torch.Generator().manual_seed(0), dtype=dtype)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in unet.named_parameters():
            if name.endswith("bias") or ("norm" in name and name.endswith("weight")):
                p.add_((0.05 * torch.randn(p.shape, generator=g)).to(p.device))
    return unet


def train_batch(rng: np.random.RandomState, b: int) -> tuple:
    """A uint8 NHWC batch and its is_clean flags: rows poisoned at
    POISON_RATE, at least one clean and one poisoned."""
    image = rng.randint(0, 256, (b, 32, 32, 3)).astype(np.uint8)
    is_clean = rng.rand(b) >= POISON_RATE
    is_clean[:2] = (True, False)
    return image, is_clean


def phase_train(dev, smi: str) -> tuple:
    """Check one f32 train step against the CPU, drive the main path (bf16
    steps at batch 128) with the launch counters set to 0 just before the
    timed steps, then split a step's device time. Returns (timed steps, the
    launch counts read just after them)."""
    print(f"-- the training path: scratch UNet {DEFAULT_SCRATCH_CONFIG.block_out_channels} at 32 px, f32 "
          "parameters, poison BOX_14 -> CORNER")
    bd = Backdoor()
    trigger = bd.get_trigger("BOX_14", 3, 32)
    target = bd.get_target("CORNER", trigger)
    consts = (trigger, target, trigger_mask(trigger))
    schedule = DDPMScheduler(DDPMConfig()).create_state().schedule
    rng = np.random.RandomState(3)

    # one f32 step at batch 2, no warmup: the card (kernels) against the CPU (plain path)
    image, is_clean = train_batch(rng, 2)
    t, noise = rng.randint(0, 1000, 2), rng.randn(2, 32, 32, 3).astype(np.float32)
    weights = seeded_scratch_unet("cpu").state_dict()
    result = {}
    for device in ("cuda", "cpu"):
        unet = UNet2DModel(DEFAULT_SCRATCH_CONFIG, device=device)
        unet.load_state_dict(weights)
        opt, _ = make_optimizer(TRAIN_LR, num_warmup_steps=0, num_training_steps=TRAIN_TOTAL)
        state = create_train_state(unet, opt, *consts)
        step = make_train_step(unet, opt, 1000, schedule.alphas, schedule.alphas_cumprod, device=device)
        state, m = step(state, image, is_clean, None, timesteps=t, noise=noise)
        result[device] = ({k: float(v) for k, v in m.items()}, {k: p.detach().cpu() for k, p in state.params.items()})
        del unet, opt, state, step
    (m_card, p_card), (m_cpu, p_cpu) = result["cuda"], result["cpu"]
    for key in ("loss", "grad_norm"):
        rel = abs(m_card[key] - m_cpu[key]) / abs(m_cpu[key])
        check(rel <= 1e-4, f"f32 train step {key}: card {m_card[key]!r} CPU {m_cpu[key]!r}")
        print(f"   f32 step B=2, card vs CPU plain path: {key} {m_card[key]:.6f} vs {m_cpu[key]:.6f}, "
              f"rel err {rel:.3g} (rtol 1e-4)")
    diff = torch.cat([(p_card[k] - p_cpu[k]).abs().flatten() for k in p_cpu])
    moved = torch.cat([(p_cpu[k] - weights[k]).abs().flatten() for k in p_cpu])
    frac = (diff > 1e-6).double().mean().item()
    # Adam's first step is lr·g/(|g|+eps): ±lr wherever |g| >> eps, so only
    # elements whose gradient is within rounding of 0 may differ, by up to 2·lr
    check(diff.max().item() <= 2 * TRAIN_LR + 1e-6 and frac <= 1e-3,
          f"f32 train step params: max diff {diff.max().item():.3g}, {frac:.3g} of them past 1e-6")
    print(f"   updated params card vs CPU: max diff {diff.max().item():.3g}, {frac:.3g} of {diff.numel()} past 1e-6 "
          f"(tolerance: max <= 2*lr = {2 * TRAIN_LR:g}, at most 1e-3 past 1e-6); largest move {moved.max().item():.3g}")
    del result, p_card, p_cpu, diff, moved

    # the main path: bf16 compute, f32 parameters, batch 128, bench.py's optimizer
    unet = seeded_scratch_unet(dev, dtype=torch.bfloat16)
    opt, _ = make_optimizer(TRAIN_LR, num_warmup_steps=TRAIN_WARMUP, num_training_steps=TRAIN_TOTAL)
    state = create_train_state(unet, opt, *consts)
    step = make_train_step(unet, opt, 1000, schedule.alphas, schedule.alphas_cumprod)
    image, is_clean = (torch.from_numpy(a).to(dev) for a in train_batch(rng, BATCH))
    gen = torch.Generator(dev).manual_seed(4)
    before = [p.detach().clone() for p in state.params.values()]
    for _ in range(TRAIN_WARMUP_CALLS):  # first calls set up cuDNN/cuBLAS
        state, m = step(state, image, is_clean, gen)
    torch.cuda.synchronize()
    metrics = []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED_STEPS):
        state, m = step(state, image, is_clean, gen)
        metrics.append(torch.stack([m["loss"], m["grad_norm"]]))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    metrics = torch.stack(metrics).cpu()
    check(bool(torch.isfinite(metrics).all()), f"bf16 train steps: loss or grad norm not finite: {metrics}")
    # a tensor may stay put only where its gradient is exactly 0: the mid
    # block's attention sees one pixel (T = 1), where softmax over one key
    # passes no gradient to its query and key projections
    unchanged = [k for (k, p), b in zip(state.params.items(), before) if torch.equal(p, b)]
    check(all(not state.params[k].grad.any() for k in unchanged),
          f"parameter tensors with a gradient unchanged after the train steps: {unchanged}")
    check(len(unchanged) < len(before), "no parameter changed in the train steps")
    del before
    ms_step = dt / TRAIN_TIMED_STEPS * 1e3
    print(f"   {TRAIN_TIMED_STEPS} bf16 train steps B={BATCH} after {TRAIN_WARMUP_CALLS} warm-up steps: "
          f"{BATCH * TRAIN_TIMED_STEPS / dt:.1f} samples/s, {ms_step:.3f} ms/step on {smi}; "
          f"loss {metrics[0, 0]:.4f} -> {metrics[-1, 0]:.4f}, grad norm {metrics[0, 1]:.4f} -> {metrics[-1, 1]:.4f}, "
          f"all finite; {len(state.params) - len(unchanged)} of {len(state.params)} parameter tensors changed, "
          f"unchanged (zero gradient): {unchanged}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    # where the time goes: device time of the forward (loss), forward + backward, and the whole step
    params = list(state.params.values())

    def forward():
        step.loss(state, image, is_clean, gen)

    def forward_backward():
        for p in params:
            p.grad = None
        step.loss(state, image, is_clean, gen).backward()

    def whole_step():
        step(state, image, is_clean, gen)

    f_ms = device_ms(forward, reps=TRAIN_PROFILE_STEPS)
    fb_ms = device_ms(forward_backward, reps=TRAIN_PROFILE_STEPS)
    wall, s_ms, kern, host = device_profile(whole_step, reps=TRAIN_PROFILE_STEPS)
    print(f"   profiled bf16 train step B={BATCH}: {wall:.3f} ms wall, {s_ms:.3f} ms device kernels, device idle "
          f"{100 * (1 - s_ms / wall):.1f}% (against the unprofiled {ms_step:.3f} ms/step: "
          f"{100 * (1 - s_ms / ms_step):.1f}%)")
    print(f"     device time per step: forward {f_ms:.3f} ms, backward {fb_ms - f_ms:.3f} ms, "
          f"optimizer (clip, Adam, zeroing) {s_ms - fb_ms:.3f} ms")
    print(f"     device time per step by layer: {breakdown(kern)}")
    print(f"     host self time per step (profiled): all ops {sum(host.values()):.3f} ms; top: {top_host_ops(host, 1)}")
    print("     host self time per step of the GroupNorm+SiLU autograd Functions (K1 forward, K2 backward): "
          + ", ".join(f"{name} {ms:.3f} ms" for name, ms in host.items() if "GroupNormSiLU" in name))
    return TRAIN_TIMED_STEPS, counts, ms_step


def state_tensors(state) -> dict:
    """Every tensor of a TrainState by checkpoint key, and its two counters."""
    names = list(state.params)
    out = {f"params/{k}": p.detach() for k, p in state.params.items()}
    out.update({f"mu/{k}": m for k, m in zip(names, state.opt_state.mu)})
    out.update({f"nu/{k}": v for k, v in zip(names, state.opt_state.nu)})
    out.update(count=state.opt_state.count, step=state.step)
    return out


def check_same_state(label: str, got: dict, want: dict) -> None:
    check(got.keys() == want.keys(), f"{label}: the state's keys differ")
    bad = [k for k in want if not (torch.equal(got[k], want[k]) if torch.is_tensor(want[k]) else got[k] == want[k])]
    check(not bad, f"{label}: not bitwise equal: {bad[:5]} ({len(bad)} of {len(want)})")


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def check_grids(run_dir: str, epochs) -> None:
    """Each epoch's clean and backdoor grid and first-frame grid: a
    GRID_PX x GRID_PX RGB PNG with finite, varied pixels."""
    from PIL import Image

    for e in epochs:
        for sub in ("samples", "backdoor_samples"):
            for name in (f"ep{e}.png", f"ep{e}_t0.png"):
                path = os.path.join(run_dir, sub, name)
                check(os.path.exists(path), f"trainer: grid {sub}/{name} missing (a swallowed sampling failure?)")
                with Image.open(path) as img:
                    arr = np.asarray(img)
                check(arr.shape == (GRID_PX, GRID_PX, 3) and arr.std() > 0, f"trainer: grid {sub}/{name} is {arr.shape}")


def step_ms(records) -> list:
    """Wall ms between consecutive logged steps of one epoch (each log reads
    the loss, so each record follows its step's end on the device)."""
    return [1e3 * (b["_time"] - a["_time"]) for a, b in zip(records, records[1:])
            if b["_step"] == a["_step"] + 1 and b["epoch"] == a["epoch"]]


def phase_trainer(dev, smi: str, bare_ms: float) -> tuple:
    """Drive train_loop for TRAINER_EPOCHS, restore its checkpoint into a
    fresh model and state, resume to TRAINER_RESUME_EPOCHS, and check the
    run's outputs. Launch counters are set to 0 just before each loop and
    read just after. Returns (train steps, sampling forwards, the summed
    launch counts)."""
    print(f"-- the trainer path: train_loop on the scratch UNet, bf16 compute on f32 parameters; FAKE "
          f"{TRAINER_FAKE_SIZE} images at 32 px, batch {BATCH}, BOX_14 -> CORNER at {POISON_RATE}; bench.py's "
          f"optimizer; grids ({TRAINER_SAMPLE_N} images, with movie) and a checkpoint every epoch; "
          f"{TRAINER_EPOCHS} epochs, then resumed to {TRAINER_RESUME_EPOCHS}. The grids sample "
          f"{TRAINER_SAMPLING_STEPS} steps, not 1000 (phase 3 runs the 1000-step chain): a cut in depth only")
    # no network here: wandb, where installed, stays off (the checks read the JSONL stream)
    os.environ["WANDB_MODE"] = "disabled"
    phase_t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    os.makedirs(TMP_BASE, exist_ok=True)
    run_dir = tempfile.mkdtemp(dir=TMP_BASE)
    try:
        dsl = DatasetLoader("FAKE", fake_size=TRAINER_FAKE_SIZE, image_size=32, batch_size=BATCH, seed=0, root=run_dir)
        dsl.set_poison("BOX_14", "CORNER", poison_rate=POISON_RATE).prepare_dataset()
        per_epoch = dsl.num_batch
        scheduler = DDPMScheduler(DDPMConfig())
        schedule = scheduler.create_state().schedule
        opt, lr_schedule = make_optimizer(TRAIN_LR, num_warmup_steps=TRAIN_WARMUP, num_training_steps=TRAIN_TOTAL)
        call_s = []  # wall seconds of each pipeline call the grids make

        class TimedPipeline(DiffusionPipeline):
            def __call__(self, *args, **kwargs):
                t0 = time.perf_counter()
                out = super().__call__(*args, **kwargs)  # returns host arrays: the device is done
                call_s.append(time.perf_counter() - t0)
                return out

        def trainer(unet):
            state = create_train_state(unet, opt, dsl.trigger, dsl.target, dsl.mask)
            step = make_train_step(unet, opt, 1000, schedule.alphas, schedule.alphas_cumprod)
            return state, step, lambda st: TimedPipeline(unet, scheduler, compute_dtype=torch.bfloat16)

        def run(state, step, make_pipeline, epochs, start_epoch=0, start_step=0):
            tracker = Tracker(os.path.join(run_dir, "logs"), config=dict(batch=BATCH, lr=TRAIN_LR, epochs=epochs))
            forwards = [0]

            def count_forward(module, args):
                if isinstance(module, UNet2DModel) and args[0].is_cuda:
                    forwards[0] += 1

            hook = torch.nn.modules.module.register_module_forward_pre_hook(count_forward)
            grids_before = len(call_s)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                state, global_step = train_loop(
                    dsl=dsl, train_step=step, state=state, lr_schedule=lr_schedule, epochs=epochs, tracker=tracker,
                    out_dir=run_dir, make_pipeline=make_pipeline, seed=0, start_epoch=start_epoch,
                    start_step=start_step, save_image_epochs=1, save_model_epochs=1, log_every=1,
                    sample_n=TRAINER_SAMPLE_N, sampling_steps=TRAINER_SAMPLING_STEPS)
            finally:
                hook.remove()
                tracker.close()
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            sampled = (len(call_s) - grids_before) * TRAINER_SAMPLING_STEPS
            check(forwards[0] == global_step - start_step + sampled,
                  f"trainer: {forwards[0]} UNet forwards, want {global_step - start_step} train + {sampled} sampling")
            return state, global_step, counts, sampled, time.perf_counter() - t0

        # the first run: epochs 0 .. TRAINER_EPOCHS-1 from step 0
        unet = seeded_scratch_unet(dev, dtype=torch.bfloat16)
        state, step, make_pipeline = trainer(unet)
        state, end1, counts1, sampled1, wall1 = run(state, step, make_pipeline, TRAINER_EPOCHS)
        steps1 = TRAINER_EPOCHS * per_epoch
        check(end1 == state.step == state.opt_state.count == steps1, f"trainer: first run ended at step {end1}")
        check_grids(run_dir, range(TRAINER_EPOCHS))
        saved = read_json(os.path.join(run_dir, "data.json"))
        check(saved == {"epoch": TRAINER_EPOCHS - 1, "step": steps1, "ckpt": "ckpt"}, f"trainer: data.json {saved}")
        live = state_tensors(state)

        # restore into a fresh model and state; the HF export from the same save
        fresh = UNet2DModel(DEFAULT_SCRATCH_CONFIG, generator=torch.Generator().manual_seed(9), dtype=torch.bfloat16)
        state2, step2, make_pipeline2 = trainer(fresh)
        state2, start_epoch, start_step = load_trainer_state(run_dir, state2)
        check((start_epoch, start_step) == (TRAINER_EPOCHS - 1, steps1),
              f"trainer: restored at epoch {start_epoch}, step {start_step}")
        check_same_state("trainer: restored state vs the live state at the save", state_tensors(state2), live)
        exported = DiffusionPipeline.from_pretrained(run_dir).unet.state_dict()
        check_same_state("trainer: HF export vs the live parameters at the save",
                         {f"params/{k}": exported[k] for k in state.params},
                         {k: v for k, v in live.items() if k.startswith("params/")})
        del exported
        print(f"   first run: {end1} steps over {TRAINER_EPOCHS} epochs in {wall1:.2f} s; data.json {saved}; restored "
              "parameters, mu, nu, count and step bitwise equal to the live state; HF export bitwise equal")

        # the resumed run re-runs the saved epoch, as the reference's resume does
        state2, end2, counts2, sampled2, wall2 = run(state2, step2, make_pipeline2, TRAINER_RESUME_EPOCHS,
                                                     start_epoch, start_step)
        steps2 = (TRAINER_RESUME_EPOCHS - start_epoch) * per_epoch
        check(end2 == state2.step == state2.opt_state.count == start_step + steps2,
              f"trainer: resumed run ended at step {end2}, want {start_step + steps2}")
        check_grids(run_dir, range(TRAINER_RESUME_EPOCHS))
        saved = read_json(os.path.join(run_dir, "data.json"))
        check(saved == {"epoch": TRAINER_RESUME_EPOCHS - 1, "step": end2, "ckpt": "ckpt"},
              f"trainer: data.json after the resume {saved}")
        logged = read_jsonl(os.path.join(run_dir, "logs", "metrics.jsonl"))
        records = [r for r in logged if "loss" in r]
        stalls = [r["ckpt_stall_s"] for r in logged if "ckpt_stall_s" in r]
        losses = [r["loss"] for r in records]
        check([r["_step"] for r in records] == list(range(steps1)) + list(range(start_step, end2)),
              f"trainer: metrics.jsonl steps {[r['_step'] for r in records]}")
        check(len(stalls) == TRAINER_EPOCHS + TRAINER_RESUME_EPOCHS - start_epoch and min(stalls) > 0,
              f"trainer: checkpoint stalls logged {stalls}")
        check(records[steps1]["epoch"] == start_epoch and bool(np.isfinite(losses).all()),
              f"trainer: resumed at epoch {records[steps1]['epoch']}, losses {losses}")
        print(f"   resumed run: epoch {start_epoch}, step {start_step} -> step {end2} in {wall2:.2f} s; "
              f"{len(records)} records, one a step, every loss finite: {losses[0]:.4f} -> {losses[-1]:.4f}")

        # timings: the loop's step from the tracker's stamps, the grids, a sync save and the HF export
        gaps = step_ms(records[:steps1]) + step_ms(records[steps1:])
        loop_ms = statistics.median(gaps)
        grid_s = [a + b for a, b in zip(call_s[::2], call_s[1::2])]
        save_dir = os.path.join(run_dir, "timed")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_trainer_state(save_dir, state2, TRAINER_RESUME_EPOCHS - 1)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        make_pipeline2(state2).save_pretrained(save_dir)
        export_s = time.perf_counter() - t0
        state_gb = sum(t.numel() * t.element_size() for t in state_tensors(state2).values() if torch.is_tensor(t)) / 1e9
        print(f"   train_loop step B={BATCH} (median of {len(gaps)} step-to-step gaps within an epoch): {loop_ms:.3f} "
              f"ms/step, {BATCH / loop_ms * 1e3:.1f} samples/s (mean {statistics.mean(gaps):.3f} ms); phase 4's bare "
              f"step {bare_ms:.3f} ms/step; on {smi}")
        print(f"   sample_grids ({TRAINER_SAMPLE_N} images, {TRAINER_SAMPLING_STEPS} steps, clean + backdoor with "
              f"movie): median {statistics.median(grid_s):.2f} s a call over {len(grid_s)} calls, "
              f"{statistics.median(call_s) / TRAINER_SAMPLING_STEPS * 1e3:.3f} ms/step a chain; on {smi}")
        print(f"   sync save_trainer_state ({state_gb:.3f} GB of parameters, mu, nu) {save_s:.3f} s; HF export "
              f"(save_pretrained) {export_s:.2f} s; on {smi}")

        # where a save's time goes: the copy to the host (pinned, as the save
        # makes it, and pageable), and the file's write from the host copy.
        # The pinned copy takes blocks that the caching host allocator kept
        # from the save before it; with that cache emptied it page-locks
        # fresh memory, as a process's first save does
        empty_host_cache()
        t0 = time.perf_counter()
        flat = checkpoint_module._host_copy(state2)
        fresh_s = time.perf_counter() - t0
        del flat
        t0 = time.perf_counter()
        flat = checkpoint_module._host_copy(state2)
        copy_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pageable = {k: t.to("cpu", copy=True) for k, t in state_tensors(state2).items() if torch.is_tensor(t)}
        pageable_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        checkpoint_module.write_safetensors(os.path.join(run_dir, "timed.safetensors"), flat)
        write_s = time.perf_counter() - t0
        del flat, pageable
        print(f"   a save's parts: host copy {copy_s:.3f} s pinned, blocks reused ({fresh_s:.3f} s into fresh pinned "
              f"memory, {pageable_s:.3f} s to pageable memory), "
              f"write_safetensors {write_s:.3f} s; on {smi}")

        # async: a train step runs before the write is finished; the read-back holds the saved bits
        async_dir = os.path.join(run_dir, "async")
        at_save = {k: v.clone() if torch.is_tensor(v) else v for k, v in state_tensors(state2).items()}
        image, is_clean = (torch.from_numpy(a).to(dev) for a in train_batch(np.random.RandomState(5), BATCH))
        t0 = time.perf_counter()
        save_trainer_state(async_dir, state2, TRAINER_RESUME_EPOCHS - 1, async_save=True)
        async_s = time.perf_counter() - t0
        step2(state2, image, is_clean, torch.Generator(dev).manual_seed(6))
        t0 = time.perf_counter()
        finish_async_saves()
        finish_s = time.perf_counter() - t0
        check(read_json(os.path.join(async_dir, "data.json"))["ckpt"] == "ckpt.v0", "trainer: async data.json")
        _, _, _ = load_trainer_state(async_dir, state)
        check_same_state("trainer: async save read back vs the state at the save", state_tensors(state), at_save)
        check(async_s < save_s, f"trainer: the async save returned in {async_s:.3f} s, a sync save took {save_s:.3f} s")
        # the same through save_checkpoint, whose HF export is written before it returns
        at_save = {k: v.clone() if torch.is_tensor(v) else v for k, v in state_tensors(state2).items()}
        t0 = time.perf_counter()
        save_checkpoint(async_dir, state2, TRAINER_RESUME_EPOCHS, make_pipeline2, async_save=True)
        async_ckpt_s = time.perf_counter() - t0
        step2(state2, image, is_clean, torch.Generator(dev).manual_seed(7))
        finish_async_saves()
        check(read_json(os.path.join(async_dir, "data.json"))["ckpt"] == "ckpt.v1", "trainer: async data.json v1")
        _, _, _ = load_trainer_state(async_dir, state)
        check_same_state("trainer: async save_checkpoint read back vs the state at the save", state_tensors(state),
                         at_save)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"   async save_trainer_state returned in {async_s:.3f} s (sync: {save_s:.3f} s), finished "
              f"{finish_s:.3f} s after a train step; async save_checkpoint (with the HF export) returned in "
              f"{async_ckpt_s:.3f} s; both read back bitwise equal to the state at the save; on {smi}")
        print(f"   peak device memory over the phase {peak:.1f} GiB; the phase took "
              f"{time.perf_counter() - phase_t0:.1f} s; on {smi}")
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
        if not os.listdir(TMP_BASE):
            os.rmdir(TMP_BASE)
    counts = {k: counts1[k] + counts2[k] for k in counts1}
    return end1 + steps2, sampled1 + sampled2, counts


class TimedStep:
    """A train or ANP step that records CUDA events around each call (and,
    for ANP, the largest |γ|, |β| after it); the step itself is unchanged."""

    def __init__(self, step, records: list, anp: bool = False):
        self.step, self.records, self.anp = step, records, anp

    def __call__(self, *args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.step(*args, **kwargs)
        end.record()
        peak = torch.stack([t.abs().max() for t in perturb_leaves(out[0])]).max() if self.anp else None
        self.records.append((start, end, peak))
        return out


def start_gaps_ms(records) -> list:
    """ms between consecutive step starts on the device's clock: a step's
    share of the loop, host and device alike."""
    return [a[0].elapsed_time(b[0]) for a, b in zip(records, records[1:])]


def seeded_inception(seed: int = 80) -> FIDInceptionV3:
    """FIDInceptionV3 on the CPU with seeded random weights and BatchNorm
    statistics (the tests' oracle's scheme): He-normal convs, γ ~ N(1,
    0.02), β and μ ~ N(0, 0.02), σ² ~ U(0.8, 1.2)."""
    g = torch.Generator().manual_seed(seed)
    model = FIDInceptionV3().eval()
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("conv.weight"):
                t.copy_(torch.randn(t.shape, generator=g) * (2.0 / t[0].numel()) ** 0.5)
            elif name.endswith("bn.weight"):
                t.copy_(1.0 + 0.02 * torch.randn(t.shape, generator=g))
            elif name.endswith(("bn.bias", "bn.running_mean")):
                t.copy_(0.02 * torch.randn(t.shape, generator=g))
            elif name.endswith("bn.running_var"):
                t.copy_(0.8 + 0.4 * torch.rand(t.shape, generator=g))
    return model


def check_activations(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    scale = want.abs().max().item()
    e = max_err(got, want)
    check(got.shape == want.shape and torch.allclose(got.float(), want.float(), rtol=1e-4, atol=1e-4 * scale),
          f"{label} card vs CPU: max err {e:.3g} (max|y| {scale:.3g})")
    print(f"   (d) {label} card vs CPU: max err {e:.3g}, max|y| {scale:.4g} (rtol 1e-4, atol 1e-4*max|y|)")
    return e


def count_pngs(path: str) -> int:
    return len([n for n in os.listdir(path) if n.endswith(".png")])


def phase_cli(dev, smi: str) -> tuple:
    """Phase 8: the CLI's train+measure, sampling and measure modes, then
    anp_cli, on the full-width UNet, with the launch counters set to 0 just
    before (a) and read just after (c); then phase 12 (c) on its run dir;
    then the metrics card against CPU and the numbers. Returns (train and
    ANP steps, sampling forwards, the launch counts, phase 12 (c)'s launch
    window)."""
    print(f"-- the CLI and anp_cli: cli train+measure (FAKE {CLI_FAKE_SIZE}, batch {BATCH}, 1 epoch, DDIM, measure "
          f"{CLI_MEASURE_N} + {CLI_MEASURE_N} images at {CLI_STEPS} steps), sampling, measure --sample_ep 0, "
          f"anp_cli (1 epoch, measure {ANP_MEASURE_N}); the scratch UNet at full width. {CLI_STEPS}-step DDIM "
          "chains, not the reference's 1000 DDPM steps (phase 3 runs those): a cut in depth only")
    os.environ["WANDB_MODE"] = "disabled"  # no network here; the checks read the JSONL streams
    phase_t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    os.makedirs(TMP_BASE, exist_ok=True)
    root = tempfile.mkdtemp(dir=TMP_BASE)
    cwd = os.getcwd()
    calls = []  # (rows, steps, seconds) of each pipeline call
    train_records, anp_records = [], []
    forwards = [0]

    class TimedPipeline(DiffusionPipeline):
        def __call__(self, batch_size=1, init=None, num_inference_steps=None, **kwargs):
            t0 = time.perf_counter()
            out = super().__call__(batch_size=batch_size, init=init, num_inference_steps=num_inference_steps,
                                   **kwargs)  # host arrays: the device is done
            rows = batch_size if init is None else len(init)
            calls.append((rows, num_inference_steps or self.default_inference_steps, time.perf_counter() - t0))
            return out

    def count_forward(module, args):
        if isinstance(module, UNet2DModel) and args[0].is_cuda:
            forwards[0] += 1

    try:
        saved = (factory.DiffusionPipeline, cli.make_train_step, anp_cli.make_anp_step)
        factory.DiffusionPipeline = TimedPipeline
        cli.make_train_step = lambda *a, **k: TimedStep(saved[1](*a, **k), train_records)
        anp_cli.make_anp_step = lambda *a, **k: TimedStep(saved[2](*a, **k), anp_records, anp=True)
        hook = torch.nn.modules.module.register_module_forward_pre_hook(count_forward)
        run = os.path.join(root, "res_None_FAKE_ep1_c1.0_p0.1_BOX_14-CORNER")
        try:
            os.chdir(root)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            # (a) train+measure
            t0 = time.perf_counter()
            cli.main(["--mode", "train+measure", "--dataset", "FAKE", "--fake_size", str(CLI_FAKE_SIZE),
                      "--batch", str(BATCH), "--epoch", "1", "--trigger", "BOX_14", "--target", "CORNER",
                      "--poison_rate", str(POISON_RATE), "--sampling_steps", str(CLI_STEPS), "--sched", "DDIM-SCHED",
                      "--measure_sample_n", str(CLI_MEASURE_N), "--eval_max_batch", str(CLI_EVAL_BATCH),
                      "--measure_steps", str(CLI_STEPS), "--gpu", "0", "-o", "-isame", "--result", root])
            wall_a = time.perf_counter() - t0
            for name in ("args.json", "config.json", "data.json", "model_index.json", "measure.json"):
                check(os.path.exists(os.path.join(run, name)), f"cli (a): {name} missing")
            data = read_json(os.path.join(run, "data.json"))
            train_steps = CLI_FAKE_SIZE // BATCH
            check(data["step"] == train_steps == len(train_records), f"cli (a): data.json {data}")
            n_png = {sub: count_pngs(os.path.join(run, "measure", sub)) for sub in ("clean_noclip", "backdoor_noclip")}
            n_png["real"] = count_pngs(os.path.join(root, "measure", "FAKE"))
            check(set(n_png.values()) == {CLI_MEASURE_N}, f"cli (a): measure PNGs {n_png}")
            score = read_json(os.path.join(run, "score.json"))
            check(set(score) == {"FID_proxy_noclip", "MSE_noclip", "SSIM_noclip"}
                  and all(np.isfinite(v) for v in score.values()) and -1.0 <= score["SSIM_noclip"] <= 1.0,
                  f"cli (a): score.json {score}")
            losses = [r["loss"] for r in read_jsonl(os.path.join(run, "logs", "metrics.jsonl")) if "loss" in r]
            check(bool(losses) and bool(np.isfinite(losses).all()), f"cli (a): logged losses {losses}")
            print(f"   (a) train+measure: {train_steps} train steps, grids, checkpoint, {n_png} PNGs in {wall_a:.2f} s; "
                  f"score.json {score}")

            # (b) sampling, then measure --sample_ep 0
            t0 = time.perf_counter()
            cli.main(["--mode", "sampling", "--ckpt", run, "--gpu", "0"])
            for sub in ("samples", "backdoor_samples"):
                check(os.path.exists(os.path.join(run, sub, "epfinal_noclip.png")), f"cli (b): {sub} grid missing")
            cli.main(["--mode", "measure", "--ckpt", run, "--sample_ep", "0", "--gpu", "0"])
            wall_b = time.perf_counter() - t0
            score = read_json(os.path.join(run, "score.json"))
            ep0 = {k: score[k.replace("_noclip", "_ep0_noclip")] for k in ("FID_proxy_noclip", "MSE_noclip", "SSIM_noclip")}
            check(all(np.isfinite(v) for v in ep0.values()) and -1.0 <= ep0["SSIM_noclip"] <= 1.0
                  and count_pngs(os.path.join(run, "measure", "ep0", "backdoor_noclip")) == CLI_MEASURE_N,
                  f"cli (b): score.json {score}")
            check(all(abs(ep0[k] - score[k]) <= 1e-3 * abs(score[k]) for k in ("MSE_noclip", "SSIM_noclip"))
                  and abs(ep0["FID_proxy_noclip"] - score["FID_proxy_noclip"]) <= 1e-2 * score["FID_proxy_noclip"],
                  f"cli (b): epoch 0's export (the final weights) scores {ep0}, the final {score}")
            print(f"   (b) sampling grids and measure --sample_ep 0 in {wall_b:.2f} s: _ep0 scores "
                  f"{ {k: score[k] for k in sorted(score) if '_ep0' in k} } (the final weights': within rtol 1e-3/1e-2)")

            # (c) anp_cli on the run dir
            t0 = time.perf_counter()
            anp_cli.main(["--ckpt", os.path.basename(run), "--epoch", "1", "--batch", str(BATCH),
                          "--fake_size", str(CLI_FAKE_SIZE), "--measure_sample_n", str(ANP_MEASURE_N),
                          "--sampling_steps", str(CLI_STEPS), "--perturb_budget", str(ANP_BUDGET), "--gpu", "0",
                          "--output_dir", os.path.join(root, "anp")])
            wall_c = time.perf_counter() - t0
        finally:
            hook.remove()
            factory.DiffusionPipeline, cli.make_train_step, anp_cli.make_anp_step = saved
            os.chdir(cwd)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        anp_dir = os.path.join(root, "anp", f"res_anp_1_lr0.0001_pb{ANP_BUDGET}_{os.path.basename(run)}")
        anp_steps = CLI_FAKE_SIZE // BATCH
        step_logs = [r for r in read_jsonl(os.path.join(anp_dir, "logs", "metrics.jsonl")) if "loss" in r]
        check(len(step_logs) == anp_steps == len(anp_records)
              and all(np.isfinite([r["loss"], r["clean_mse"], r["backdoor_mse"]]).all() for r in step_logs),
              f"cli (c): ANP step logs {step_logs}")
        peaks = [rec[2].item() for rec in anp_records]
        check(max(peaks) <= ANP_BUDGET, f"cli (c): largest |γ|, |β| after each step {peaks}")
        score_anp = read_json(os.path.join(anp_dir, "score.json"))
        check(set(score_anp) == {"MSE", "MSE_ep1", "MSE_best", "SSIM", "SSIM_ep1", "SSIM_best"}
              and all(np.isfinite(v) for v in score_anp.values()), f"cli (c): score.json {score_anp}")
        exported, _, _ = factory.get_trained(anp_dir, dtype=torch.float32, device=dev)
        base, _, _ = factory.get_trained(run, dtype=torch.float32, device=dev)
        x = torch.randn(2, 32, 32, 3, generator=torch.Generator(dev).manual_seed(81), device=dev)
        with torch.inference_mode():
            y = exported(x, torch.tensor([10, 900], device=dev))
        moved = sum(not torch.equal(a, b) for a, b in zip(exported.parameters(), base.parameters()))
        check(bool(torch.isfinite(y).all()) and moved > 0, f"cli (c): export reloaded, {moved} tensors moved")
        del exported, base
        print(f"   (c) anp_cli: {anp_steps} ANP steps, grids, measure, export in {wall_c:.2f} s; losses "
              f"{step_logs[0]['loss']:.4f} -> {step_logs[-1]['loss']:.4f}, backdoor_mse "
              f"{step_logs[0]['backdoor_mse']:.4f} -> {step_logs[-1]['backdoor_mse']:.4f}; largest |γ|, |β| "
              f"{max(peaks):.4f} (budget {ANP_BUDGET}); score.json {score_anp}; export reloaded through "
              f"factory.get_trained, {moved} parameter tensors perturbed, forward finite")
        segment_runs = segment_measure(root, run, smi)  # phase 12 (c), on this run dir
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if not os.listdir(TMP_BASE):
            os.rmdir(TMP_BASE)

    # the forwards of the chains: (a) grids 2 chains and measure 2 x 2 chunks, (b) grids and a
    # measure again, (c) grids at epoch 0, a 128-image measure (one chunk) and the final grids
    sampled = sum(steps for _, steps, _ in calls)
    chunks = -(-CLI_MEASURE_N // CLI_EVAL_BATCH)
    want = CLI_STEPS * (2 + 2 * chunks + 2 + 2 * chunks + 2 + 1 + 2)
    steps = train_steps + anp_steps
    check(sampled == want and forwards[0] == steps + sampled,
          f"cli: {forwards[0]} UNet forwards, {sampled} in chains (designed {want}), {steps} steps")

    # (d) card against CPU
    rng = np.random.RandomState(82)
    a = rng.rand(CLI_MEASURE_N, 32, 32, 3).astype(np.float32)
    b = np.clip(a + 0.2 * rng.randn(*a.shape), 0, 1).astype(np.float32)
    for name, fn in (("mse", mse), ("ssim", ssim)):
        got, want_v = float(fn(a, b, device=dev)), float(fn(a, b, device="cpu"))
        check(abs(got - want_v) <= 1e-4 * abs(want_v), f"{name} card {got!r} vs CPU {want_v!r}")
        print(f"   (d) {name} [{CLI_MEASURE_N}, 32, 32, 3] card vs CPU: {got!r} vs {want_v!r} (rtol 1e-4)")
    check_activations(f"proxy extractor [{CLI_MEASURE_N}, 32, 32, 3]", proxy_extractor(dev)(a).cpu(),
                      proxy_extractor("cpu")(a))
    inception = seeded_inception()
    xi = torch.from_numpy(a[: INCEPTION_CHECK_SHAPE[0]])
    want_i = inception(xi)
    inception_card = inception.to(dev, memory_format=torch.channels_last)
    check_activations(f"FIDInceptionV3 {list(INCEPTION_CHECK_SHAPE)} -> 299^2", inception_card(xi.to(dev)).cpu(),
                      want_i)
    t0 = time.perf_counter()
    fid_card = fid([a, b], device=dev)
    fid_cpu = fid([a, b], device="cpu")
    check(abs(fid_card - fid_cpu) <= 1e-3 * abs(fid_cpu), f"FID card {fid_card!r} vs CPU {fid_cpu!r}")
    print(f"   (d) FID (proxy) of two seeded {CLI_MEASURE_N}-image sets card vs CPU: {fid_card!r} vs {fid_cpu!r} "
          f"(rtol 1e-3); both, with their host sqrtm, {time.perf_counter() - t0:.1f} s")

    # (e) the numbers
    xb = torch.from_numpy(a[:INCEPTION_BATCH]).to(dev)
    inc_ms = time_ms(lambda: inception_card(xb), reps=5, repeats=3)
    train_gap, anp_gap = start_gaps_ms(train_records), start_gaps_ms(anp_records)
    anp_dev = [s.elapsed_time(e) for s, e, _ in anp_records]
    measure_calls = [(r, s, dt) for r, s, dt in calls if r == CLI_EVAL_BATCH]
    rows, secs = sum(r for r, _, _ in measure_calls), sum(dt for _, _, dt in measure_calls)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"   (e) CLI train step B={BATCH} (bf16 compute): median {statistics.median(train_gap):.3f} ms/step between "
          f"step starts over {len(train_gap)} gaps ({BATCH / statistics.median(train_gap) * 1e3:.1f} samples/s) "
          f"on {smi}")
    print(f"   (e) ANP step B={BATCH} (bf16 compute, loss read back each step): median "
          f"{statistics.median(anp_gap):.3f} ms between step starts, {statistics.median(anp_dev):.3f} ms from a "
          f"step's start to its end on the device, over {len(anp_gap)} gaps on {smi}")
    print(f"   (e) measure chains, f32 without TF32, {CLI_STEPS} DDIM steps at B={CLI_EVAL_BATCH}: "
          f"{len(measure_calls)} chains, {rows / secs:.2f} imgs/s, {secs / len(measure_calls) / CLI_STEPS * 1e3:.3f} "
          f"ms/step on {smi}")
    print(f"   (e) FIDInceptionV3 f32 without TF32, B={INCEPTION_BATCH} at 32 px -> 299^2: {inc_ms:.3f} ms a batch, "
          f"{INCEPTION_BATCH / inc_ms * 1e3:.1f} imgs/s on {smi}")
    print(f"   (e) phase 8 took {time.perf_counter() - phase_t0:.1f} s ((a) {wall_a:.1f} s, (b) {wall_b:.1f} s, "
          f"(c) {wall_c:.1f} s); peak device memory {peak:.1f} GiB; on {smi}")
    return steps, sampled, counts, segment_runs


def kernel_calls(*modules) -> tuple:
    """(K1, K3, bias_shift) launches one call of ``modules`` together makes,
    from their built modules: each GroupNorm that fuses its SiLU runs K1
    once, each attention block K3 once, each Conv2d the bias shift once."""
    found = [m for module in modules for m in module.modules()]
    return (sum(isinstance(m, GroupNorm) and m.silu for m in found), sum(isinstance(m, AttentionBlock) for m in found),
            sum(isinstance(m, Conv2d) for m in found))


def scratch_launches(forwards: int, backwards: int = 0) -> dict:
    """The launch counts of ``forwards`` scratch-UNet forwards, ``backwards``
    of them with a backward (each K1 call then has its K2, each conv its
    bias_shift_backward)."""
    return {"groupnorm_silu": GN_PER_FORWARD * forwards, "groupnorm_silu_backward": GN_PER_FORWARD * backwards,
            "attention": ATTN_PER_FORWARD * forwards, "bias_shift": CONV_PER_FORWARD * forwards,
            "bias_shift_backward": CONV_PER_FORWARD * backwards, "vq_nearest": 0}


class CallCounter:
    """Counts calls on the card of the given module classes (forward
    pre-hooks on every module), by class name, while it is entered."""

    def __init__(self, *classes):
        self.classes = classes
        self.counts = {c.__name__: 0 for c in classes}

    def _hook(self, module, args):
        if isinstance(module, self.classes) and torch.is_tensor(args[0]) and args[0].is_cuda:
            self.counts[type(module).__name__] += 1

    def __enter__(self):
        self.handle = torch.nn.modules.module.register_module_forward_pre_hook(self._hook)
        return self

    def __exit__(self, *exc):
        self.handle.remove()


def want_launches(calls: dict, per: dict, steps: int = 0, step: tuple = (0, 0, 0)) -> dict:
    """The launch counts a run should show: ``per[name] = (K1, K3, convs)``
    for each counted module call, and ``steps`` train steps of ``step`` =
    (K1, K3, convs) (each K1 with its K2, each conv with its backward); one
    nearest-code search a VQ decode (a ``Decoder`` call)."""
    k1, k3, convs = (sum(n * per[name][i] for name, n in calls.items()) + steps * step[i] for i in range(3))
    return {"groupnorm_silu": k1, "groupnorm_silu_backward": steps * step[0], "attention": k3, "bias_shift": convs,
            "bias_shift_backward": steps * step[2], "vq_nearest": calls.get("Decoder", 0)}


def check_card_vs_cpu(label: str, got: torch.Tensor, want: torch.Tensor) -> None:
    scale = want.abs().max().item()
    e = max_err(got.cpu(), want)
    check(got.shape == want.shape and torch.allclose(got.cpu(), want, rtol=1e-3, atol=1e-3 * scale),
          f"{label} card vs CPU: max err {e:.3g} (|y| max {scale:.3g})")
    print(f"   {label}, card vs CPU plain path: max err {e:.3g}, |y| max {scale:.3g} (rtol 1e-3, atol 1e-3*max|y|)")


def phase_latent(dev, smi: str) -> tuple:
    """Phase 9: (a) the LDM-CELEBA-HQ-256 path at full width, staged and
    reloaded through the factory, checked card against CPU, then bf16 DDIM
    chains from pixel noise (+ trigger) and the CLI's sampling and measure
    modes on the staged run dir; (b) NCSN++ 256 px: a forward card against
    CPU, an SDE-VE chain and VE score steps. Launch counters set to 0 just
    before each counted window and read just after. Returns [(path, what ran,
    counts, wanted counts)]."""
    print(f"-- phase 9 (a): LDM-CELEBA-HQ-256 at full width (UNet {mc.LDM_CELEBA_HQ_256_UNET.block_out_channels} at "
          f"64 px, VQ-VAE {mc.LDM_CELEBA_HQ_256_VQ.block_out_channels} at 256 px, "
          f"{mc.LDM_CELEBA_HQ_256_VQ.num_vq_embeddings} codes), seeded weights; {LDM_STEPS}-step chains and measure "
          "(the reference measures with 1000 steps: a cut in depth)")
    phase_t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    px, lat = mc.LDM_CELEBA_HQ_256_VQ.sample_size, mc.LDM_CELEBA_HQ_256_UNET.sample_size
    os.makedirs(TMP_BASE, exist_ok=True)
    root = tempfile.mkdtemp(dir=TMP_BASE)
    cwd = os.getcwd()
    runs = []
    try:
        run = os.path.join(root, "ldm_run")
        t0 = time.perf_counter()
        staged = mc.stage_ldm(run, device=dev, fake_size=LDM_FAKE_SIZE)
        stage_s = time.perf_counter() - t0
        unet, sched, get_pipeline = factory.get_pretrained(run, dtype=torch.float32, device=dev)
        pipe = get_pipeline(sched, device=dev)
        check(isinstance(pipe, LDMPipeline) and sched.config == mc.LDM_CELEBA_HQ_256_SCHEDULER,
              f"factory.get_pretrained on the LDM dir gave {type(pipe).__name__}, {sched.config}")
        for name, a, b in (("unet", staged.unet, pipe.unet), ("vqvae", staged.vqvae, pipe.vqvae)):
            sd_a, sd_b = a.state_dict(), b.state_dict()
            check(sd_a.keys() == sd_b.keys() and all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a),
                  f"{name} weights changed through stage_ldm/get_pretrained")
        del staged
        per = {"UNet2DModel": kernel_calls(pipe.unet),
               "Encoder": kernel_calls(pipe.vqvae.encoder, pipe.vqvae.quant_conv),
               "Decoder": kernel_calls(pipe.vqvae.decoder, pipe.vqvae.post_quant_conv)}
        check(per == LDM_KERNEL_CALLS, f"LDM kernel calls per module call {per}, designed {LDM_KERNEL_CALLS}")
        n_unet = sum(p.numel() for p in pipe.unet.parameters())
        n_vq = sum(p.numel() for p in pipe.vqvae.parameters())
        print(f"   staged ({stage_s:.1f} s) and reloaded through factory.get_pretrained, weights exact: UNet {n_unet} "
              f"and VQ-VAE {n_vq} parameters; (K1, K3, convs) a call: {per}")

        # f32 on the card against the CPU's plain path, B=1
        cpu = LDMPipeline.from_pretrained(run, device="cpu")
        g = torch.Generator().manual_seed(91)
        codebook = cpu.vqvae.quantize.embedding.weight.detach()
        idx = torch.randint(0, codebook.shape[0], (1, lat, lat), generator=g)
        # codebook rows, nudged: the nearest row is the same on both sides
        latents = codebook[idx] + 1e-3 * torch.randn(1, lat, lat, 3, generator=g)
        x_pix = torch.randn(1, px, px, 3, generator=g)
        x_lat, t = torch.randn(1, lat, lat, 3, generator=g), torch.tensor([500])
        with torch.inference_mode():
            check_card_vs_cpu("f32 VQ decode B=1", pipe.decode(latents.to(dev)), cpu.decode(latents))
            check_card_vs_cpu("f32 VQ encode B=1", pipe.encode(x_pix.to(dev)), cpu.encode(x_pix))
            check_card_vs_cpu("f32 LDM UNet forward B=1", pipe.unet(x_lat.to(dev), t.to(dev)), cpu.unet(x_lat, t))
        del cpu

        # the chains: bf16 UNet, f32 VQ-VAE, from pixel noise and noise + trigger
        pipe.compute_dtype = torch.bfloat16
        gen = torch.Generator(dev).manual_seed(92)
        noise = torch.randn(pipe.sample_shape(LDM_BATCH), generator=gen, device=dev)
        trigger = torch.from_numpy(Backdoor().get_trigger("BOX_14", 3, px)).to(dev)
        pipe(init=noise[:2], num_inference_steps=2)  # warm-up: first bf16 calls set up cuDNN/cuBLAS
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with CallCounter(UNet2DModel, Encoder, Decoder) as calls:
            chain_s = []
            for name, init in (("clean", noise), ("backdoor", noise + trigger[None])):
                t0 = time.perf_counter()
                out = pipe(init=init, generator=gen, num_inference_steps=LDM_STEPS, output_type="pt")
                torch.cuda.synchronize()
                chain_s.append(time.perf_counter() - t0)
                imgs = out.images
                check(tuple(imgs.shape) == (LDM_BATCH, px, px, 3), f"LDM {name} images {tuple(imgs.shape)}")
                check(bool(torch.isfinite(out.sample).all()) and imgs.min().item() >= 0.0 and imgs.max().item() <= 1.0,
                      f"LDM {name}: decoded sample not finite or images outside [0, 1]")
        counts = ops.launch_counts()
        want_calls = {"UNet2DModel": 2 * LDM_STEPS, "Encoder": 2, "Decoder": 2}
        check(calls.counts == want_calls, f"LDM chains made {calls.counts}, designed {want_calls}")
        runs.append(("LDM chains", f"{calls.counts} calls", counts, want_launches(calls.counts, per)))
        peak_chain = torch.cuda.max_memory_allocated() / 2**30
        with torch.inference_mode():
            lat16 = pipe.encode(noise)
            enc_ms = time_ms(lambda: pipe.encode(noise), reps=2, repeats=2)
            dec_ms = time_ms(lambda: pipe.decode(lat16), reps=2, repeats=2)
            unet_bf16 = pipe.unet.compute_copy(torch.bfloat16)
            tb = torch.full((LDM_BATCH,), 500, device=dev)
            fwd_ms = time_ms(lambda: unet_bf16(lat16, tb), reps=10, repeats=3)
        del unet_bf16
        for name, s_ in zip(("clean", "backdoor"), chain_s):
            print(f"   {LDM_STEPS}-step bf16 DDIM chain B={LDM_BATCH}, {name} (pixel init encoded, latents decoded): "
                  f"{s_:.3f} s, {LDM_BATCH / s_:.3f} imgs/s, {(s_ * 1e3 - enc_ms - dec_ms) / LDM_STEPS:.3f} ms a chain "
                  f"step (wall less one encode and one decode) on {smi}")
        print(f"   B={LDM_BATCH}: VQ encode f32 {enc_ms:.3f} ms, VQ decode f32 {dec_ms:.3f} ms, bf16 UNet forward "
              f"{fwd_ms:.3f} ms (CUDA events); peak device memory of the chains {peak_chain:.1f} GiB on {smi}")

        # the CLI on the staged run dir: sampling (grids), then measure (64 + 64 images)
        os.environ["WANDB_MODE"] = "disabled"
        os.chdir(root)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with CallCounter(UNet2DModel, Encoder, Decoder) as calls:
            cli.main(["--mode", "sampling", "--ckpt", run, "--gpu", GPU, "--sampling_steps", str(LDM_STEPS)])
            t_sampling = time.perf_counter() - t0
            cli.main(["--mode", "measure", "--ckpt", run, "--gpu", GPU, "--measure_sample_n", str(LDM_MEASURE_N),
                      "--eval_max_batch", str(LDM_MEASURE_N), "--measure_steps", str(LDM_STEPS)])
        torch.cuda.synchronize()
        wall_cli = time.perf_counter() - t0
        counts = ops.launch_counts()
        os.chdir(cwd)
        for sub in ("samples", "backdoor_samples"):
            check(os.path.exists(os.path.join(run, sub, "epfinal_noclip.png")), f"LDM cli sampling: {sub} grid")
        n_png = {sub: count_pngs(os.path.join(run, "measure", sub)) for sub in ("clean_noclip", "backdoor_noclip")}
        n_png["real"] = count_pngs(os.path.join(root, "measure", "FAKE"))
        check(set(n_png.values()) == {LDM_MEASURE_N}, f"LDM cli measure: PNGs {n_png}")
        score = read_json(os.path.join(run, "score.json"))
        check(set(score) == {"FID_proxy_noclip", "MSE_noclip", "SSIM_noclip"}
              and all(np.isfinite(v) for v in score.values()) and -1.0 <= score["SSIM_noclip"] <= 1.0,
              f"LDM cli measure: score.json {score}")
        # sampling: two 16-image chains, each decoding its 10 movie frames and its result; measure: two 64-image
        # chains; every chain encodes its pixel init once
        want_calls = {"UNet2DModel": 4 * LDM_STEPS, "Encoder": 4, "Decoder": 2 * 11 + 2}
        check(calls.counts == want_calls, f"LDM cli made {calls.counts}, designed {want_calls}")
        runs.append(("LDM CLI", f"{calls.counts} calls", counts, want_launches(calls.counts, per)))
        print(f"   cli --mode sampling ({t_sampling:.1f} s) and --mode measure {LDM_MEASURE_N} + {LDM_MEASURE_N} "
              f"images, f32 chains without TF32 ({wall_cli - t_sampling:.1f} s); PNGs {n_png}; score.json {score}")
        del pipe, unet, get_pipeline
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
        if not os.listdir(TMP_BASE):
            os.rmdir(TMP_BASE)
    print(f"   phase 9 (a) took {time.perf_counter() - phase_t0:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB on {smi}")

    cfg = mc.NCSNPP_CELEBA_HQ_256
    print(f"-- phase 9 (b): NCSN++ (google/ncsnpp-celebahq-256) at full width, {cfg.block_out_channels} at 256 px, "
          f"seeded weights; a {NCSNPP_CHAIN_STEPS}-step SDE-VE chain (its default is 2000: a cut in depth) and "
          f"{NCSNPP_TRAIN_STEPS} VE score steps")
    phase_t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    unet = UNet2DModel(cfg, device=dev, generator=torch.Generator().manual_seed(93))
    per = {"UNet2DModel": kernel_calls(unet)}
    check(per["UNet2DModel"] == NCSNPP_KERNEL_CALLS, f"NCSN++ (K1, K3, convs) a forward {per}, designed {NCSNPP_KERNEL_CALLS}")
    cpu_unet = UNet2DModel(cfg, device="cpu")
    cpu_unet.load_state_dict(unet.state_dict())
    g = torch.Generator().manual_seed(94)
    size = cfg.sample_size
    x, sigma = torch.randn(1, size, size, 3, generator=g), torch.tensor([7.5])
    with torch.inference_mode():
        check_card_vs_cpu("f32 NCSN++ forward B=1", unet(x.to(dev), sigma.to(dev)), cpu_unet(x, sigma))
    del cpu_unet

    sde = ScoreSdeVeScheduler()
    chain_pipe = DiffusionPipeline(unet, sde, default_inference_steps=2000, hf_class_name="ScoreSdeVePipeline",
                                   compute_dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(dev).manual_seed(95)
    chain_pipe(batch_size=NCSNPP_CHAIN_BATCH, generator=gen, num_inference_steps=1)  # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with CallCounter(UNet2DModel) as calls:
        t0 = time.perf_counter()
        out = chain_pipe(batch_size=NCSNPP_CHAIN_BATCH, generator=gen, num_inference_steps=NCSNPP_CHAIN_STEPS,
                         output_type="pt")
        torch.cuda.synchronize()
        chain_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    imgs = out.images
    check(bool(torch.isfinite(out.sample).all()) and imgs.min().item() >= 0.0 and imgs.max().item() <= 1.0
          and tuple(imgs.shape) == (NCSNPP_CHAIN_BATCH, size, size, 3), "NCSN++ SDE-VE chain: sample not finite")
    want_calls = {"UNet2DModel": NCSNPP_CHAIN_STEPS * (sde.config.correct_steps + 1)}
    check(calls.counts == want_calls, f"NCSN++ chain made {calls.counts}, designed {want_calls}")
    runs.append(("NCSN++ SDE-VE chain", f"{calls.counts} calls", counts, want_launches(calls.counts, per)))
    print(f"   {NCSNPP_CHAIN_STEPS}-step bf16 SDE-VE chain B={NCSNPP_CHAIN_BATCH}: {chain_s:.3f} s, "
          f"{chain_s / NCSNPP_CHAIN_STEPS * 1e3:.3f} ms a step ({sde.config.correct_steps + 1} forwards), "
          f"|sample| max {out.sample.abs().max().item():.4g} before the clip, on {smi}")
    del chain_pipe, out, unet

    model = UNet2DModel(cfg, device=dev, generator=torch.Generator().manual_seed(96), dtype=torch.bfloat16)
    optimizer, _ = make_optimizer(NCSNPP_LR, num_warmup_steps=0, num_training_steps=1000)
    state = create_score_train_state(model, optimizer)
    step = make_ve_train_step(model, optimizer, sde.create_state().discrete_sigmas, device=dev)
    rng = np.random.RandomState(97)
    images = [torch.from_numpy((rng.rand(NCSNPP_TRAIN_BATCH, size, size, 3) * 255).astype(np.uint8)).to(dev)
              for _ in range(NCSNPP_TRAIN_STEPS + 1)]
    gen = torch.Generator(dev).manual_seed(98)
    step(state, images[0], gen)  # warm-up step
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    records, metrics = [], []
    with CallCounter(UNet2DModel) as calls:
        for img in images[1:]:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step(state, img, gen)
            end.record()
            records.append((start, end))
            metrics.append(m)
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    check(bool(np.isfinite(losses + norms).all()) and state.step == NCSNPP_TRAIN_STEPS + 1,
          f"NCSN++ score steps: losses {losses}, grad norms {norms}")
    check(calls.counts == {"UNet2DModel": NCSNPP_TRAIN_STEPS}, f"NCSN++ score steps made {calls.counts}")
    runs.append(("NCSN++ score steps", f"{NCSNPP_TRAIN_STEPS} steps", counts,
                 want_launches({}, per, NCSNPP_TRAIN_STEPS, per["UNet2DModel"])))
    step_ms = [s_.elapsed_time(e) for s_, e in records]
    print(f"   VE score steps B={NCSNPP_TRAIN_BATCH} (bf16 compute, f32 parameters, Adam lr {NCSNPP_LR}): losses "
          f"{[round(v, 4) for v in losses]}, grad norms {[round(v, 4) for v in norms]}; median "
          f"{statistics.median(step_ms):.3f} ms a step (CUDA events, start to end) on {smi}")
    print(f"   phase 9 (b) took {time.perf_counter() - phase_t0:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB on {smi}")
    return runs


class ForwardCounter:
    """Counts the UNet2DModel forwards on the card while it is entered,
    apart by whether autograd records them (a train, ANP or score step's
    forward, each of whose K1 calls has its K2 in the backward) or not (a
    chain's)."""

    def __init__(self):
        self.grad = self.nograd = 0

    def _hook(self, module, args):
        if isinstance(module, UNet2DModel) and torch.is_tensor(args[0]) and args[0].is_cuda:
            if torch.is_grad_enabled():
                self.grad += 1
            else:
                self.nograd += 1

    def __enter__(self):
        self.handle = torch.nn.modules.module.register_module_forward_pre_hook(self._hook)
        return self

    def __exit__(self, *exc):
        self.handle.remove()

    def what(self) -> str:
        return f"{self.grad} forwards with a backward, {self.nograd} without"

    def want(self, per: tuple) -> dict:
        k1, k3, convs = per
        n = self.grad + self.nograd
        return {"groupnorm_silu": k1 * n, "groupnorm_silu_backward": k1 * self.grad, "attention": k3 * n,
                "bias_shift": convs * n, "bias_shift_backward": convs * self.grad, "vq_nearest": 0}


def counted(runs: list, path: str, per: tuple, fn):
    """``fn()`` with the launch counters set to 0 just before and read just
    after, its UNet forwards counted; appends the window to ``runs``.
    Returns (fn's result, the ForwardCounter, seconds)."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with ForwardCounter() as fc:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    runs.append((path, fc.what(), ops.launch_counts(), fc.want(per)))
    return out, fc, dt


def stage_ddpm(path: str, config, seed: int, dev) -> UNet2DModel:
    """A seeded DDPM pipeline directory in the HF layout, with the
    ``args.json`` a run dir has, as ``model_configs.stage_ldm`` writes one:
    what ``--ckpt`` reads as it reads a hub checkpoint."""
    unet = UNet2DModel(config, device=dev, generator=torch.Generator().manual_seed(seed))
    DiffusionPipeline(unet, DDPMScheduler(DDPMConfig()), device=dev).save_pretrained(path)
    args = {"mode": "train", "dataset": "FAKE", "batch": BATCH, "epoch": 1, "ckpt": os.path.basename(path),
            "trigger": "BOX_14", "target": "CORNER", "poison_rate": POISON_RATE, "overwrite": True,
            "image_size": config.sample_size}
    with open(os.path.join(path, "args.json"), "w") as f:
        json.dump(args, f, indent=2)
    return unet


def check_chain(label: str, out, shape: tuple) -> None:
    imgs = out.images
    check(tuple(imgs.shape) == shape, f"{label}: images {tuple(imgs.shape)}, designed {shape}")
    check(bool(torch.isfinite(out.sample).all()) and imgs.min().item() >= 0.0 and imgs.max().item() <= 1.0,
          f"{label}: sample not finite or images outside [0, 1]")


def print_device_time(label: str, stats: dict, smi: str) -> None:
    print(f"   {label}: {stats['wall_ms_per_step']:.3f} ms/step wall, {stats['device_time_ms_per_step']:.3f} ms/step "
          f"device kernels, device idle {100 * stats['idle_share']:.1f}% on {smi}")
    print(f"     device time per step: {profiling.format_by_class(stats['by_class'])}")


def poisoned_step(model, size: int, batch: int, grad_accum: int, dev):
    """(step, state, one poisoned FAKE batch on the card) of the backdoor
    train step at ``size`` px: bench.py's optimizer, BOX_14 -> CORNER at 0.1."""
    dsl = DatasetLoader(DatasetLoader.FAKE, image_size=size, batch_size=batch, fake_size=batch)
    dsl.set_poison("BOX_14", "CORNER", poison_rate=POISON_RATE).prepare_dataset()
    schedule = DDPMScheduler(DDPMConfig()).create_state().schedule
    opt, _ = make_optimizer(TRAIN_LR, num_warmup_steps=TRAIN_WARMUP, num_training_steps=TRAIN_TOTAL)
    state = create_train_state(model, opt, dsl.trigger, dsl.target, dsl.mask)
    step = make_train_step(model, opt, 1000, schedule.alphas, schedule.alphas_cumprod, grad_accum=grad_accum,
                           use_remat=False, device=dev)
    b = next(dsl.epoch_batches(0))
    return step, state, torch.from_numpy(b["image_u8"]).to(dev), torch.from_numpy(b["is_clean"]).to(dev)


def phase_published(dev, smi: str) -> list:
    """Phase 10: (a) google/ddpm-cifar10-32 and (b) google/ddpm-ema-celebahq-256
    at full width, seeded; (c) the three demos through their ``run(...)``,
    cut in depth. Launch counters set to 0 just before each counted window
    and read just after. Returns [(path, what ran, counts, wanted counts)]."""
    runs = []
    os.environ["WANDB_MODE"] = "disabled"
    os.makedirs(TMP_BASE, exist_ok=True)
    root = tempfile.mkdtemp(dir=TMP_BASE)
    cwd = os.getcwd()
    try:
        os.chdir(root)  # the CLI's run dir is named after --ckpt; the measure's dump is cwd-relative
        phase_published_cifar10(dev, smi, root, runs)
        phase_published_celebahq(dev, smi, runs)
        phase_published_demos(dev, smi, root, runs)
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
        if os.path.isdir(TMP_BASE) and not os.listdir(TMP_BASE):
            os.rmdir(TMP_BASE)
    return runs


def phase_published_cifar10(dev, smi: str, root: str, runs: list) -> None:
    cfg = mc.DDPM_CIFAR10_32
    print(f"-- phase 10 (a): google/ddpm-cifar10-32 at full width ({cfg.block_out_channels}, one head as wide as its "
          f"block), seeded; the CLI fine-tune {CIFAR_FAKE_SIZE // BATCH} bf16 steps at batch {BATCH} (its grids "
          f"{CHAIN_STEPS} steps), a {CHAIN_STEPS}-step chain: cuts in depth")
    phase_t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    name = "ddpm_cifar10_32"
    staged = stage_ddpm(os.path.join(root, name), cfg, 100, dev)
    unet, sched, get_pipeline = factory.get_pretrained(os.path.join(root, name), dtype=torch.float32, device=dev)
    sd_a, sd_b = staged.state_dict(), unet.state_dict()
    check(unet.config == cfg and all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a),
          "DDPM-CIFAR10-32: weights or config changed through save_pretrained/get_pretrained")
    del staged, sd_a, sd_b
    per = kernel_calls(unet)
    n_params = sum(p.numel() for p in unet.parameters())
    check(per == PUBLISHED_KERNEL_CALLS["DDPM-CIFAR10-32"] and n_params == 35_746_307,
          f"DDPM-CIFAR10-32: {n_params} parameters, (K1, K3, convs) a forward {per}")
    print(f"   staged and reloaded through factory.get_pretrained, weights exact: {n_params} parameters; (K1, K3, convs) a "
          f"forward {per}, K2 {per[0]} a backward")
    cpu_unet = UNet2DModel(cfg, device="cpu")
    cpu_unet.load_state_dict(unet.state_dict())
    g = torch.Generator().manual_seed(101)
    x, t = torch.randn(2, 32, 32, 3, generator=g), torch.tensor([10, 900])
    with torch.inference_mode():
        check_card_vs_cpu("f32 DDPM-CIFAR10-32 forward B=2", unet(x.to(dev), t.to(dev)), cpu_unet(x, t))
    del cpu_unet

    # the CLI fine-tunes the staged checkpoint, as the reference fine-tunes the hub's
    run = os.path.join(root, f"res_{name}_FAKE_ep1_c1.0_p{POISON_RATE}_BOX_14-CORNER")
    _, fc, wall = counted(runs, "DDPM-CIFAR10-32 CLI fine-tune", per, lambda: cli.main(
        ["--mode", "train", "--ckpt", name, "--dataset", "FAKE", "--fake_size", str(CIFAR_FAKE_SIZE), "--batch",
         str(BATCH), "--epoch", "1", "--trigger", "BOX_14", "--target", "CORNER", "--poison_rate", str(POISON_RATE),
         "--sampling_steps", str(CHAIN_STEPS), "--gpu", GPU, "-o", "--result", root]))
    steps = CIFAR_FAKE_SIZE // BATCH
    data = read_json(os.path.join(run, "data.json"))
    losses = [r["loss"] for r in read_jsonl(os.path.join(run, "logs", "metrics.jsonl")) if "loss" in r]
    check(data["step"] == steps == fc.grad and bool(losses) and bool(np.isfinite(losses).all())
          and fc.nograd == 2 * CHAIN_STEPS and os.path.exists(os.path.join(run, "model_index.json")),
          f"DDPM-CIFAR10-32 CLI fine-tune: data.json {data}, losses {losses}, {fc.what()}")
    print(f"   cli --mode train --ckpt (the staged dir): {steps} steps, losses {[round(v, 4) for v in losses]}, "
          f"grids and export in {wall:.1f} s")

    pipe = get_pipeline(sched, device=dev, compute_dtype=torch.bfloat16)
    gen = torch.Generator(dev).manual_seed(102)
    pipe(batch_size=2, generator=gen, num_inference_steps=2)  # warm-up
    out, _, wall = counted(runs, "DDPM-CIFAR10-32 chain", per, lambda: pipe(
        batch_size=SAMPLE_BATCH, generator=gen, num_inference_steps=CHAIN_STEPS, output_type="pt"))
    check_chain("DDPM-CIFAR10-32 chain", out, (SAMPLE_BATCH, 32, 32, 3))
    print(f"   {CHAIN_STEPS}-step bf16 DDPM chain B={SAMPLE_BATCH}: {wall:.3f} s, {SAMPLE_BATCH / wall:.3f} imgs/s, "
          f"{wall / CHAIN_STEPS * 1e3:.3f} ms/step on {smi}")
    stats = profiling.measure_device_time(
        lambda: pipe(batch_size=SAMPLE_BATCH, generator=gen, num_inference_steps=PROFILE_CHAIN_STEPS,
                     output_type="pt"), steps=1)
    print_device_time(f"profiled {PROFILE_CHAIN_STEPS}-step chain (a step = one chain)", stats, smi)
    model = UNet2DModel(cfg, device=dev, generator=torch.Generator().manual_seed(103), dtype=torch.bfloat16)
    step, state, image, is_clean = poisoned_step(model, 32, BATCH, 1, dev)
    stats = profiling.measure_device_time(lambda: step(state, image, is_clean, gen), steps=TRAIN_PROFILE_STEPS)
    print_device_time(f"bf16 train step B={BATCH}", stats, smi)
    del unet, pipe, model, step, state, out
    print(f"   phase 10 (a) DDPM-CIFAR10-32 took {time.perf_counter() - phase_t0:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB on {smi}")


def phase_published_celebahq(dev, smi: str, runs: list) -> None:
    cfg = mc.DDPM_EMA_CELEBAHQ_256
    print(f"-- phase 10 (b): google/ddpm-ema-celebahq-256 at full width ({cfg.block_out_channels}, 256 px), seeded; a "
          f"{CHAIN_STEPS}-step bf16 DDIM chain at B={CELEBA_CHAIN_BATCH}, {CELEBA_TRAIN_STEPS} steps of the 256 px "
          f"recipe (micro-batch {CELEBA_MICRO} x grad-accum {CELEBA_ACCUM}, bench.py)")
    phase_t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    unet = UNet2DModel(cfg, device=dev, generator=torch.Generator().manual_seed(104))
    per = kernel_calls(unet)
    n_params = sum(p.numel() for p in unet.parameters())
    check(per == PUBLISHED_KERNEL_CALLS["DDPM-EMA-CELEBAHQ-256"] and n_params == 113_673_219,
          f"DDPM-EMA-CELEBAHQ-256: {n_params} parameters, (K1, K3, convs) a forward {per}")
    cpu_unet = UNet2DModel(cfg, device="cpu")
    cpu_unet.load_state_dict(unet.state_dict())
    g = torch.Generator().manual_seed(105)
    x, t = torch.randn(1, 256, 256, 3, generator=g), torch.tensor([500])
    with torch.inference_mode():
        check_card_vs_cpu("f32 DDPM-EMA-CELEBAHQ-256 forward B=1", unet(x.to(dev), t.to(dev)), cpu_unet(x, t))
    del cpu_unet
    pipe = DiffusionPipeline(unet, DDIMScheduler(DDIMConfig()), default_inference_steps=CHAIN_STEPS,
                             hf_class_name="DDIMPipeline", compute_dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(dev).manual_seed(106)
    pipe(batch_size=2, generator=gen, num_inference_steps=2)  # warm-up
    out, _, wall = counted(runs, "DDPM-EMA-CELEBAHQ-256 DDIM chain", per, lambda: pipe(
        batch_size=CELEBA_CHAIN_BATCH, generator=gen, num_inference_steps=CHAIN_STEPS, output_type="pt"))
    check_chain("DDPM-EMA-CELEBAHQ-256 chain", out, (CELEBA_CHAIN_BATCH, 256, 256, 3))
    print(f"   {CHAIN_STEPS}-step bf16 DDIM chain B={CELEBA_CHAIN_BATCH}: {wall:.3f} s, "
          f"{CELEBA_CHAIN_BATCH / wall:.3f} imgs/s, {wall / CHAIN_STEPS * 1e3:.3f} ms/step on {smi}")
    stats = profiling.measure_device_time(
        lambda: pipe(batch_size=CELEBA_CHAIN_BATCH, generator=gen, num_inference_steps=PROFILE_CHAIN_STEPS,
                     output_type="pt"), steps=1)
    print_device_time(f"profiled {PROFILE_CHAIN_STEPS}-step DDIM chain B={CELEBA_CHAIN_BATCH} (a step = one chain)",
                      stats, smi)
    del unet, pipe, out
    model = UNet2DModel(cfg, device=dev, generator=torch.Generator().manual_seed(107), dtype=torch.bfloat16)
    step, state, image, is_clean = poisoned_step(model, 256, CELEBA_MICRO * CELEBA_ACCUM, CELEBA_ACCUM, dev)
    state, m = step(state, image, is_clean, gen)  # warm-up: first 256 px calls set up cuDNN/cuBLAS
    metrics = []

    def recipe_steps():
        nonlocal state
        for _ in range(CELEBA_TRAIN_STEPS):
            state, m = step(state, image, is_clean, gen)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))

    _, fc, wall = counted(runs, "DDPM-EMA-CELEBAHQ-256 256 px recipe", per, recipe_steps)
    check(fc.grad == CELEBA_TRAIN_STEPS * CELEBA_ACCUM and fc.nograd == 0 and bool(np.isfinite(metrics).all()),
          f"DDPM-EMA-CELEBAHQ-256 recipe steps: {fc.what()}, (loss, grad norm) {metrics}")
    samples = CELEBA_MICRO * CELEBA_ACCUM
    print(f"   256 px recipe, bf16 compute on f32 parameters, {CELEBA_MICRO} x {CELEBA_ACCUM} = {samples} a step: "
          f"(loss, grad norm) {[(round(a, 4), round(b, 4)) for a, b in metrics]}; "
          f"{wall / CELEBA_TRAIN_STEPS * 1e3:.3f} ms a step wall ({samples * CELEBA_TRAIN_STEPS / wall:.2f} "
          f"samples/s) on {smi}")
    stats = profiling.measure_device_time(lambda: step(state, image, is_clean, gen), steps=1)
    print_device_time("profiled 256 px recipe step", stats, smi)
    del model, step, state
    print(f"   phase 10 (b) DDPM-EMA-CELEBAHQ-256 took {time.perf_counter() - phase_t0:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB on {smi}")


def phase_published_demos(dev, smi: str, root: str, runs: list) -> None:
    print(f"-- phase 10 (c): the demos through their run(...), cut in depth: attack {ATTACK_STEPS} of 3000 steps, "
          f"{DEMO_N} of 64 images, {DEMO_CHAIN}-step chains (not 1000); ANP {ANP_DEMO_STEPS} of 300 steps on that run; "
          f"VE score {VE_STEPS} of 4000 steps, a {VE_CHAIN}-step PC chain (not 2000) of {VE_N} images")
    phase_t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    models = (("attack", attack_demo.ATTACK_MODEL_CONFIG), ("score", train_sde_ve.SCORE_MODEL_CONFIG))
    per = {name: kernel_calls(UNet2DModel(config, device="meta")) for name, config in models}
    check(per == {"attack": PUBLISHED_KERNEL_CALLS["attack demo"], "score": PUBLISHED_KERNEL_CALLS["score demo"]},
          f"the demo models' (K1, K3, convs) a forward {per}")
    attack_dir = os.path.join(root, "attack_demo_out")
    res, fc, wall = counted(runs, "attack demo", per["attack"], lambda: attack_demo.run(
        ATTACK_STEPS, attack_dir, n=DEMO_N, sampling_steps=DEMO_CHAIN, device=dev))
    with open(os.path.join(attack_dir, "result.json")) as f:
        saved = json.load(f)
    check(fc.grad == ATTACK_STEPS and fc.nograd == 2 * DEMO_CHAIN
          and sorted(os.listdir(attack_dir)) == ["args.json", "backdoor_grid.png", "clean_grid.png",
                                                 "model_index.json", "result.json", "scheduler", "unet"]
          and all(np.isfinite(v) for v in saved.values()) and len(saved) == 4,
          f"attack demo: {fc.what()}, files {sorted(os.listdir(attack_dir))}, result {saved}")
    print(f"   attack demo: {saved}; {ATTACK_STEPS} steps in {res['train_s']:.1f} s ({res['train_steps_per_s']:.2f} "
          f"steps/s), sampling {res['sample_s']:.1f} s, wall {wall:.1f} s on {smi}")

    defense_dir = os.path.join(root, "defense_demo_out")
    res, fc, wall = counted(runs, "defense demo", per["attack"], lambda: defense_demo.run(
        attack_dir, ANP_DEMO_STEPS, out=defense_dir, n=DEMO_N, sampling_steps=DEMO_CHAIN, device=dev))
    check(fc.grad == ANP_DEMO_STEPS and fc.nograd == 2 * DEMO_CHAIN
          and np.isfinite(res["backdoor_mse_before"]) and np.isfinite(res["backdoor_mse_after"])
          and abs(res["backdoor_mse_before"] - saved["backdoor_mse"]) <= 1e-2 * saved["backdoor_mse"],
          f"defense demo: {fc.what()}, {res}; the attack's backdoor_mse {saved['backdoor_mse']}")
    print(f"   defense demo: backdoor_mse {res['backdoor_mse_before']:.6g} -> {res['backdoor_mse_after']:.6g} "
          f"(before: the attack's own chain reloaded, rtol 1e-2); {ANP_DEMO_STEPS} ANP steps in {res['anp_s']:.1f} s "
          f"({res['anp_steps_per_s']:.2f} steps/s), wall {wall:.1f} s on {smi}")

    ve_dir = os.path.join(root, "sde_ve_out")
    sde_forwards = VE_CHAIN * (ScoreSdeVeScheduler().config.correct_steps + 1)
    row, fc, wall = counted(runs, "VE score demo", per["score"], lambda: train_sde_ve.run(
        VE_STEPS, n=VE_N, out=ve_dir, dataset="FAKE", sampling_steps=VE_CHAIN, device=dev))
    check(fc.grad == VE_STEPS and fc.nograd == sde_forwards and np.isfinite(row["FID_proxy"])
          and np.isfinite(row["final_loss"]) and len(os.listdir(os.path.join(ve_dir, "pc_samples"))) == VE_N
          and os.path.exists(os.path.join(ve_dir, "result.json")),
          f"VE score demo: {fc.what()}, row {row}")
    print(f"   VE score demo: FID_proxy {row['FID_proxy']} (on {VE_N} images), final loss {row['final_loss']:.4f}; "
          f"{VE_STEPS} steps in {row['train_s']:.1f} s ({row['train_steps_per_s']:.2f} steps/s), the chain "
          f"{row['sample_s']:.1f} s ({row['imgs_per_sec']} imgs/s), wall {wall:.1f} s on {smi}")

    # where the time goes on the demo models
    model = UNet2DModel(attack_demo.ATTACK_MODEL_CONFIG, device=dev, generator=torch.Generator().manual_seed(108),
                        dtype=torch.bfloat16)
    gen = torch.Generator(dev).manual_seed(109)
    step, state, image, is_clean = poisoned_step(model, 32, BATCH, 1, dev)
    print_device_time(f"attack model, bf16 train step B={BATCH}",
                      profiling.measure_device_time(lambda: step(state, image, is_clean, gen),
                                                    steps=TRAIN_PROFILE_STEPS), smi)
    pipe = DiffusionPipeline(model, DDPMScheduler(DDPMConfig()), device=dev)
    print_device_time(f"attack model, profiled {PROFILE_CHAIN_STEPS}-step DDPM chain B={DEMO_N} (a step = one chain)",
                      profiling.measure_device_time(lambda: pipe(batch_size=DEMO_N, generator=gen, output_type="pt",
                                                                 num_inference_steps=PROFILE_CHAIN_STEPS), steps=1),
                      smi)
    del model, step, state, pipe
    print(f"   phase 10 (c) took {time.perf_counter() - phase_t0:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB on {smi}")


# phase 11: scale-out on the one card. (a) a one-rank NCCL world; (b) two ranks sharing cuda:0 over gloo, each at
# BATCH // 2 rows, in every layout: (name, model_parallel, param_sharding)
SCALE_RANKS = 2
SCALE_LAYOUTS = (("replicated", 1, "replicated"), ("fsdp", 1, "fsdp"), ("tp", 2, "replicated"),
                 ("tp_fsdp", 2, "fsdp"))
SCALE_BF16_STEPS, SCALE_F32_STEPS, SCALE_SAVE_AFTER = 3, 2, 2
SCALE_CLI_FAKE, SCALE_CLI_STEPS, SCALE_CLI_MEASURE, SCALE_CLI_EVAL_BATCH = 256, 10, 32, 16
SCALE_TIMEOUT_S = 600


def scale_batches(n: int) -> list:
    rng = np.random.RandomState(11)
    return [train_batch(rng, BATCH) for _ in range(n)]


def scale_world(dev, dtype, mesh=None, sharding="replicated"):
    """(state, step, layout) of the seeded full-width UNet computing in
    ``dtype``: bench.py's optimizer in bf16, no warmup in f32 (so that one
    step moves the parameters); on ``mesh`` when given."""
    bd = Backdoor()
    trigger = bd.get_trigger("BOX_14", 3, 32)
    schedule = DDPMScheduler(DDPMConfig()).create_state().schedule
    unet = seeded_scratch_unet(dev, dtype=dtype)
    opt, _ = make_optimizer(TRAIN_LR, num_warmup_steps=TRAIN_WARMUP if dtype == torch.bfloat16 else 0,
                            num_training_steps=TRAIN_TOTAL)
    state = create_train_state(unet, opt, trigger, bd.get_target("CORNER", trigger), trigger_mask(trigger))
    layout = None
    if mesh is not None:
        layout = parallel.ParallelLayout(mesh, unet, sharding)
        state = parallel.place_train_state(state, layout)
    step = make_train_step(unet, opt, 1000, schedule.alphas, schedule.alphas_cumprod, device=dev, layout=layout)
    return state, step, layout


def scale_step(state, step, layout, batch, index: int, dev):
    """Step ``index`` on this rank's rows, drawing as train_loop does (a
    generator seeded from the step alone, so a resumed run draws the same)."""
    image, is_clean = batch if layout is None else (layout.batch(batch[0]), layout.batch(batch[1]))
    gen = torch.Generator(dev).manual_seed(step_seed(0, index))
    return step(state, torch.from_numpy(image).to(dev), torch.from_numpy(is_clean).to(dev), gen)


def whole_params(state, layout) -> dict:
    params = state.params if layout is None else layout.full_params(state.params)
    return {k: p.detach().to("cpu", copy=True) for k, p in params.items()}


def params_digest(params: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(params):
        h.update(params[k].numpy().tobytes())
    return h.hexdigest()


class TimedCollectives:
    """torch.distributed as the layout module sees it, with its three
    collectives timed from a synchronised start to a synchronised end (gloo
    stages CUDA tensors through the host and returns when done, so nothing
    overlaps them anyway)."""

    def __init__(self):
        self.ms = 0.0

    def __getattr__(self, name):
        fn = getattr(torch.distributed, name)
        if name not in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor"):
            return fn

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.ms += (time.perf_counter() - t0) * 1e3
            return out

        return timed


def scaleout_rank(role: str, rank: int, store_path: str, root: str, device: str = "cuda:0") -> None:
    """One of SCALE_RANKS processes on cuda:0 over gloo (``--gpu 0,0``).
    ``train``: per layout, the f32 steps (rank 0 saves the whole parameters)
    and the bf16 steps with a checkpoint after step SCALE_SAVE_AFTER;
    ``resume``: per layout, the checkpoint restored into a fresh state and
    the last bf16 step again; ``cli``: cli.main train+measure and anp_cli.
    Each writes ``<root>/<role>-rank<r>.json``."""
    from baddiffusion_tpu_torch.config import shares_card
    from baddiffusion_tpu_torch.parallel import layout as layout_module

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["WANDB_MODE"] = "disabled"
    dev = torch.device(device)
    backend = distributed.initialize(dev, shares_card("0,0"), rank=rank, world_size=SCALE_RANKS,
                                     store=torch.distributed.FileStore(store_path, SCALE_RANKS),
                                     timeout_s=SCALE_TIMEOUT_S)
    check(backend == "gloo", f"two ranks on one card joined over {backend}")
    timer = TimedCollectives()
    layout_module.dist = timer
    out = {"rank": rank}
    if role == "cli":
        out.update(scaleout_rank_cli(rank, root, f"{dev.index},{dev.index}" if dev.type == "cuda" else "cpu"))
    else:
        batches = scale_batches(SCALE_BF16_STEPS)
        for name, mp, sharding in SCALE_LAYOUTS:
            mesh = parallel.make_mesh(dev, mp)
            rec = out[name] = {}
            if role == "train":
                state, step, layout = scale_world(dev, torch.float32, mesh, sharding)
                metrics = []
                for i in range(SCALE_F32_STEPS):
                    state, m = scale_step(state, step, layout, batches[i], i, dev)
                    metrics.append([float(m["loss"]), float(m["grad_norm"])])
                params = whole_params(state, layout)
                if rank == 0:
                    torch.save(params, os.path.join(root, f"f32-{name}.pt"))
                rec["f32"] = metrics
                del state, step, layout, params
            state, step, layout = scale_world(dev, torch.bfloat16, mesh, sharding)
            ckpt = os.path.join(root, f"ckpt-{name}")
            first = 0
            if role == "resume":
                state, _, first = load_trainer_state(ckpt, state, layout)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            metrics, times = [], []
            for i in range(first, SCALE_BF16_STEPS):
                if role == "train" and i == SCALE_SAVE_AFTER:
                    save_trainer_state(ckpt, state, epoch=0, layout=layout)
                torch.cuda.synchronize()
                t0, c0 = time.perf_counter(), timer.ms
                state, m = scale_step(state, step, layout, batches[i], i, dev)
                metrics.append([float(m["loss"]), float(m["grad_norm"])])  # waits for the device
                times.append([(time.perf_counter() - t0) * 1e3, timer.ms - c0])
            rec.update(bf16=metrics, steps=[first, SCALE_BF16_STEPS], ms=times, counts=ops.launch_counts(),
                       digest=params_digest(whole_params(state, layout)))
            del state, step, layout
            torch.cuda.empty_cache()
    with open(os.path.join(root, f"{role}-rank{rank}.json"), "w") as f:
        json.dump(out, f)
    distributed.shutdown()


def scaleout_rank_cli(rank: int, root: str, gpu: str) -> dict:
    """cli.main train+measure on FAKE, then anp_cli on the run, on the two
    ranks (``--gpu 0,0``: both on one card; cut in depth); the UNet forwards
    this rank made, counted."""
    run = os.path.join(root, "res_None_FAKE_ep1_c1.0_p0.1_BOX_14-CORNER")
    os.chdir(root)  # the measure's real-image dump is cwd-relative
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with ForwardCounter() as fc:
        t0 = time.perf_counter()
        cli.main(["--mode", "train+measure", "--dataset", "FAKE", "--fake_size", str(SCALE_CLI_FAKE),
                  "--batch", str(BATCH), "--epoch", "1", "--trigger", "BOX_14", "--target", "CORNER",
                  "--poison_rate", str(POISON_RATE), "--sampling_steps", str(SCALE_CLI_STEPS), "--sched", "DDIM-SCHED",
                  "--measure_sample_n", str(SCALE_CLI_MEASURE), "--eval_max_batch", str(SCALE_CLI_EVAL_BATCH),
                  "--measure_steps", str(SCALE_CLI_STEPS), "--gpu", gpu, "-o", "--result", root])
        wall_cli = time.perf_counter() - t0
        anp_cli.main(["--ckpt", run, "--epoch", "1", "--batch", str(BATCH), "--fake_size", str(SCALE_CLI_FAKE),
                      "--measure_sample_n", str(SCALE_CLI_EVAL_BATCH), "--sampling_steps", str(SCALE_CLI_STEPS),
                      "--gpu", gpu, "--output_dir", os.path.join(root, "anp")])
        wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return {"counts": ops.launch_counts(), "want": fc.want((GN_PER_FORWARD, ATTN_PER_FORWARD, CONV_PER_FORWARD)), "what": fc.what(),
            "wall_cli": wall_cli, "wall": wall, "run": run}


def launch_ranks(role: str, root: str, dev) -> list:
    """SCALE_RANKS processes of this script in ``role`` on ``dev``'s card;
    their JSON results."""
    store = os.path.join(root, f"store-{role}")
    card = f"cuda:{dev.index or 0}" if dev.type == "cuda" else str(dev)
    logs = [os.path.join(root, f"{role}-rank{r}.log") for r in range(SCALE_RANKS)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:  # a file, not a pipe: nothing blocks on output nobody reads while polling
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--scaleout-rank", role, str(r),
                                           store, root, card], stdout=f, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + SCALE_TIMEOUT_S
    try:
        # a rank that fails ends the launch at once: its peer would wait out the collectives' timeout
        while any(p.poll() is None for p in procs) and all(p.poll() in (None, 0) for p in procs):
            check(time.monotonic() < deadline, f"scale-out {role}: the ranks ran past {SCALE_TIMEOUT_S} s")
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            with open(log) as f:
                print(f.read()[-6000:])
        check(p.returncode == 0, f"scale-out {role}: rank {r} exited {p.returncode}")
    return [read_json(os.path.join(root, f"{role}-rank{r}.json")) for r in range(SCALE_RANKS)]


def phase_scaleout(dev, smi: str) -> list:
    """Phase 11: (a) a one-rank NCCL world's train step bitwise the bare
    step's; (b) two ranks on the card over gloo in each layout, f32 against
    one rank, bf16 bitwise across the ranks and across a kill/restart, each
    rank's launch counts; (c) the CLI and anp_cli on the two ranks. Returns
    the counted windows as main() takes them."""
    print(f"-- phase 11, scale-out: the scratch UNet at full width, B={BATCH}; (a) one NCCL rank, (b) {SCALE_RANKS} "
          f"ranks sharing the card over gloo ({BATCH // SCALE_RANKS} rows each) in the layouts "
          f"{[n for n, _, _ in SCALE_LAYOUTS]}, (c) the CLI and anp_cli on the {SCALE_RANKS} ranks")
    phase_t0 = time.perf_counter()
    os.makedirs(TMP_BASE, exist_ok=True)
    root = tempfile.mkdtemp(dir=TMP_BASE)
    runs = []
    try:
        # (a) the bare step, then the same through a one-rank NCCL world
        batch = scale_batches(1)[0]
        state, step, _ = scale_world(dev, torch.bfloat16)
        state, m = scale_step(state, step, None, batch, 0, dev)
        want = (m["loss"].clone(), m["grad_norm"].clone(), {k: p.detach().clone() for k, p in state.params.items()})
        del state, step
        backend = distributed.initialize(dev, store=torch.distributed.FileStore(os.path.join(root, "store-nccl"), 1),
                                         rank=0, world_size=1, timeout_s=SCALE_TIMEOUT_S)
        try:
            check(backend == "nccl", f"one rank with a card of its own joined over {backend}")
            state, step, layout = scale_world(dev, torch.bfloat16, parallel.make_mesh(dev))
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            state, m = scale_step(state, step, layout, batch, 0, dev)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
        finally:
            distributed.shutdown()
        same = (torch.equal(m["loss"], want[0]) and torch.equal(m["grad_norm"], want[1])
                and all(torch.equal(p, want[2][k]) for k, p in state.params.items()))
        check(same, f"(a) one-rank NCCL step: loss {float(m['loss'])!r} grad norm {float(m['grad_norm'])!r}, the "
                    f"bare step's {float(want[0])!r} {float(want[1])!r}, parameters bitwise equal: {same}")
        print(f"   (a) one NCCL rank, bf16 step at B={BATCH}: loss {float(m['loss']):.6f}, grad norm "
              f"{float(m['grad_norm']):.6f}, parameters: bitwise the bare step's")
        runs.append(("scale-out (a), one NCCL rank", "1 train step", counts, scratch_launches(1, 1)))
        del state, step, layout, want
        torch.cuda.empty_cache()

        # (b) the one-rank f32 reference at B=BATCH, then the two ranks, then a fresh pair resuming
        batches = scale_batches(SCALE_F32_STEPS)
        state, step, _ = scale_world(dev, torch.float32)
        ref = []
        for i in range(SCALE_F32_STEPS):
            state, m = scale_step(state, step, None, batches[i], i, dev)
            ref.append([float(m["loss"]), float(m["grad_norm"])])
        ref_params = whole_params(state, None)
        del state, step
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        train = launch_ranks("train", root, dev)
        wall_train = time.perf_counter() - t0
        t0 = time.perf_counter()
        resume = launch_ranks("resume", root, dev)
        wall_resume = time.perf_counter() - t0
        for name, mp, sharding in SCALE_LAYOUTS:
            for label, results in (("train", train), ("resume", resume)):
                recs = [r[name] for r in results]
                check(len({json.dumps(r["bf16"]) + r["digest"] for r in recs}) == 1,
                      f"(b) {name} {label}: the ranks disagree: {[r['bf16'] for r in recs]}")
                for r, rec in enumerate(recs):
                    n = rec["steps"][1] - rec["steps"][0]
                    runs.append((f"scale-out (b) {name} {label}, rank {r}", f"{n} train steps on {BATCH // SCALE_RANKS}"
                                 " rows", rec["counts"], scratch_launches(n, n)))
            got, back = train[0][name], resume[0][name]
            check(back["bf16"] == got["bf16"][SCALE_SAVE_AFTER:] and back["digest"] == got["digest"],
                  f"(b) {name}: resumed step {back['bf16']} and parameters, uninterrupted {got['bf16']}")
            rel = np.abs(np.array(got["f32"]) - np.array(ref)) / np.abs(np.array(ref))
            check(bool((rel <= 1e-4).all()), f"(b) {name} f32 loss/grad norm {got['f32']}, one rank {ref}")
            params = torch.load(os.path.join(root, f"f32-{name}.pt"))
            diff = torch.cat([(params[k] - ref_params[k]).abs().flatten() for k in ref_params])
            dmax, frac = diff.max().item(), (diff > 1e-6).double().mean().item()
            check(dmax <= 2 * SCALE_F32_STEPS * TRAIN_LR + 1e-6 and frac <= 1e-3,
                  f"(b) {name} f32 parameters: max diff {dmax:.3g}, {frac:.3g} past 1e-6")
            del params, diff
            ms = [rec["ms"][-1] for rec in (train[0][name], train[1][name])]
            print(f"   (b) {name} (model_parallel {mp}, {sharding}): f32 x{SCALE_F32_STEPS} vs one rank at B={BATCH}: "
                  f"max rel err of loss/grad norm {rel.max():.3g} (rtol 1e-4), parameters max diff {dmax:.3g} "
                  f"({frac:.3g} past 1e-6; at most {2 * SCALE_F32_STEPS * TRAIN_LR:g} and 1e-3); "
                  f"bf16 x{SCALE_BF16_STEPS}: ranks bitwise equal, "
                  f"resumed step {SCALE_SAVE_AFTER + 1} bitwise; step {SCALE_BF16_STEPS} per rank "
                  + ", ".join(f"rank {r} {t:.1f} ms ({c:.1f} ms in collectives, {100 * c / t:.1f}%)"
                              for r, (t, c) in enumerate(ms)))
        print(f"   (b) launches: train {wall_train:.1f} s, resume {wall_resume:.1f} s of wall time. gloo stages every "
              "collective through the host, so these times are no measure of NCCL across cards; no scaling is claimed")

        # (c) the CLI and anp_cli on the two ranks
        cli_runs = launch_ranks("cli", root, dev)
        run = cli_runs[0]["run"]
        score = read_json(os.path.join(run, "score.json"))
        check(set(score) == {"FID_proxy_noclip", "MSE_noclip", "SSIM_noclip"}
              and all(np.isfinite(v) for v in score.values()), f"(c) score.json {score}")
        n_png = {sub: count_pngs(os.path.join(run, "measure", sub)) for sub in ("clean_noclip", "backdoor_noclip")}
        check(set(n_png.values()) == {SCALE_CLI_MEASURE}, f"(c) measure PNGs {n_png}")
        check(read_json(os.path.join(run, "data.json"))["step"] == SCALE_CLI_FAKE // BATCH, "(c) data.json step")
        anp_dir = os.path.join(root, "anp", f"res_anp_1_lr0.0001_pb4.0_{run}")
        anp_score = read_json(os.path.join(anp_dir, "score.json"))
        check({"MSE", "MSE_ep1", "MSE_best", "SSIM", "SSIM_ep1", "SSIM_best"} <= set(anp_score)
              and all(np.isfinite(v) for v in anp_score.values()), f"(c) ANP score.json {anp_score}")
        for r, res in enumerate(cli_runs):
            runs.append((f"scale-out (c) CLI and ANP, rank {r}", res["what"], res["counts"], res["want"]))
        print(f"   (c) cli train+measure ({SCALE_CLI_FAKE // BATCH} steps, {n_png} PNGs) then anp_cli (1 epoch) on "
              f"{SCALE_RANKS} ranks: rank 0 in {cli_runs[0]['wall']:.1f} s (CLI {cli_runs[0]['wall_cli']:.1f} s); "
              f"score.json {score}; ANP {anp_score}")
        print(f"   phase 11 took {time.perf_counter() - phase_t0:.1f} s on {smi}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if os.path.isdir(TMP_BASE) and not os.listdir(TMP_BASE):
            os.rmdir(TMP_BASE)
    return runs


SEG_STEPS, SEG_ZOO_STEPS, SEG_ZOO_SEGMENT, SEG_CLI = 100, 20, 7, 25
SEG_ZOO = ("DDIM-SCHED", "DPM_SOLVER_PP_O2-SCHED", "UNIPC-SCHED", "PNDM-SCHED", "SCORE-SDE-VE-SCHED")


def check_graph_equal(label: str, got, want, gen_got, gen_want) -> None:
    """A segmented call's outputs and its caller's generator bitwise the eager call's."""
    check(torch.equal(got.sample, want.sample) and torch.equal(got.images, want.images),
          f"{label}: the graphs' sample differs from the eager chain's by up to {max_err(got.sample, want.sample):.3g}")
    if want.movie is not None:
        check(torch.equal(got.movie, want.movie) and torch.equal(got.movie[-1], got.images),
              f"{label}: the graphs' movie differs from the eager chain's")
    check(torch.equal(gen_got.get_state(), gen_want.get_state()),
          f"{label}: the caller's generator ends elsewhere than after the eager chain")


def phase_segments(dev, smi: str) -> list:
    """Phase 12 (a), (b), (d): segment mode as CUDA graphs on the card,
    bitwise against the eager chains, with the launch counters set to 0
    just before and read just after; then the numbers. Returns its launch
    window for main's table."""
    print(f"-- segment mode: chains as CUDA graphs of N steps; the scratch UNet at full width, bf16; "
          f"{SEG_STEPS}-step DDPM at B={BATCH} (a), five schedulers at B={SAMPLE_BATCH} (b)")
    phase_t0 = time.perf_counter()
    unet = seeded_scratch_unet(dev)
    pipe = DiffusionPipeline(unet, DDPMScheduler(DDPMConfig()), compute_dtype=torch.bfloat16)
    trigger = torch.from_numpy(Backdoor().get_trigger("BOX_14", 3, 32)).to(dev)
    noise = torch.randn(BATCH, 32, 32, 3, generator=torch.Generator(dev).manual_seed(120), device=dev)
    init = noise + trigger[None]
    forwards = [0]

    def call(pipeline, seg, seed, chain_forwards, **kw):
        """One call from a generator seeded ``seed``; returns (output, generator, wall s)."""
        pipeline.segment_steps = seg
        gen = torch.Generator(dev).manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipeline(generator=gen, output_type="pt", **kw)
        torch.cuda.synchronize()
        forwards[0] += chain_forwards
        return out, gen, time.perf_counter() - t0

    pipe(init=init[:2], num_inference_steps=2)  # the kernels' first calls and cuDNN's choices, uncounted
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    times = {}
    segments.reset_captures()
    # (a) 100 steps at B=128 from noise + trigger: segments of 25 and of 30 (a remainder segment)
    kw = dict(init=init, num_inference_steps=SEG_STEPS)
    eager, gen_e, times["eager_128"] = call(pipe, None, 1, SEG_STEPS, **kw)
    for seg in (25, 30):
        got, gen_g, dt = call(pipe, seg, 1, SEG_STEPS, **kw)
        times.setdefault(f"first_{BATCH}", dt)  # segments of 25: the call that captures
        check_graph_equal(f"segments of {seg}, B={BATCH}", got, eager, gen_g, gen_e)
    # another generator replays the cached graphs
    eager2, gen_e2, _ = call(pipe, None, 2, SEG_STEPS, **kw)
    got, gen_g2, times["replay_128"] = call(pipe, 25, 2, SEG_STEPS, **kw)
    check_graph_equal(f"segments of 25, B={BATCH}, a second generator", got, eager2, gen_g2, gen_e2)
    check(not torch.equal(eager.sample, eager2.sample), "two generators gave the same chain")
    for extra in (dict(save_every_step=True, capture_every=3), dict(start_from=4)):
        n_fwd = SEG_STEPS - extra.get("start_from", 0)
        want, gen_w, _ = call(pipe, None, 3, n_fwd, **kw, **extra)
        got, gen_g, _ = call(pipe, 25, 3, n_fwd, **kw, **extra)
        check_graph_equal(f"segments of 25, B={BATCH}, {extra}", got, want, gen_g, gen_w)
        if "capture_every" in extra:
            check(got.movie.shape == (34, BATCH, 32, 32, 3), f"movie shape {tuple(got.movie.shape)}")
    print(f"   (a) {SEG_STEPS}-step bf16 DDPM at B={BATCH} from noise + BOX_14: segments of 25 and of 30 "
          f"bitwise the eager chain (sample, images, the generator's state after); a second generator "
          f"replays the cached graphs bitwise its eager chain; capture_every=3 (34 frames) and "
          f"start_from=4 bitwise")

    # (b) five schedulers at B=16, 20 steps, segments of 7
    zoo_ms = []
    for name in SEG_ZOO:
        scheduler, kind = zoo_scheduler(name)
        zpipe = factory._make_get_pipeline(unet, kind, factory.DiffuserModelSched.CLIP_SAMPLE_DEFAULT)(
            scheduler, compute_dtype=torch.bfloat16)
        zkw = dict(init=init[:SAMPLE_BATCH], num_inference_steps=SEG_ZOO_STEPS)
        n_fwd = zoo_forwards(scheduler, kind, SEG_ZOO_STEPS)[1]
        want, gen_w, _ = call(zpipe, None, 4, n_fwd, **zkw)
        got, gen_g, _ = call(zpipe, SEG_ZOO_SEGMENT, 4, n_fwd, **zkw)
        check_graph_equal(f"{name} in segments of {SEG_ZOO_SEGMENT}", got, want, gen_g, gen_w)
        check(bool(torch.isfinite(got.sample).all()), f"{name}: sample not finite")
        zoo_ms.append(f"{name} {len(zpipe._graphs)} chain(s), {n_fwd} forwards")
    print(f"   (b) bitwise the eager chains at B={SAMPLE_BATCH}, {SEG_ZOO_STEPS} steps, segments of "
          f"{SEG_ZOO_SEGMENT}: {'; '.join(zoo_ms)}")

    # (d) ms a chain step, eager and replayed, at B=16 and B=128
    kw16 = dict(init=init[:SAMPLE_BATCH], num_inference_steps=SEG_STEPS)
    _, _, times["eager_16"] = call(pipe, None, 5, SEG_STEPS, **kw16)
    _, _, times["first_16"] = call(pipe, 25, 5, SEG_STEPS, **kw16)
    _, _, times["replay_16"] = call(pipe, 25, 6, SEG_STEPS, **kw16)
    counts = ops.launch_counts()
    captured = segments.captures()
    want_fwd = forwards[0] + len(captured)
    want = scratch_launches(want_fwd)
    for b in (SAMPLE_BATCH, BATCH):
        print(f"   (d) B={b}, {SEG_STEPS}-step DDPM: eager {times[f'eager_{b}'] / SEG_STEPS * 1e3:.3f} ms/step, graphs "
              f"replayed {times[f'replay_{b}'] / SEG_STEPS * 1e3:.3f} ms/step (segments of 25), first call with "
              f"its capture {times[f'first_{b}'] / SEG_STEPS * 1e3:.3f} ms/step; on {smi}")
    print(f"   (d) {len(captured)} chains captured, {statistics.median(captured):.2f} s a capture "
          f"(median; max {max(captured):.2f} s: warm-up forward, capture, synchronise)")
    pipe.segment_steps = 25
    gen = torch.Generator(dev).manual_seed(7)
    wall, dev_ms, kern, _ = device_profile(lambda: pipe(init=init[:SAMPLE_BATCH], generator=gen,
                                                        num_inference_steps=SEG_STEPS, output_type="pt"), reps=1)
    by_class = profiling.device_time_by_class(kern)
    k1 = [k for k in kern if "groupnorm_silu_fwd_kernel" in k]
    k3 = [k for k in kern if "attention_packed_kernel" in k]
    print(f"   (d) profiled replay of a {SEG_STEPS}-step chain at B={SAMPLE_BATCH} (4 graphs): "
          f"{wall / SEG_STEPS:.3f} ms/step wall, {dev_ms / SEG_STEPS:.3f} ms/step device kernels, device idle "
          f"{100 * max(0.0, 1 - dev_ms / wall):.1f}%; kernels by name: {k1[:1]} {by_class['K1'] / SEG_STEPS:.4f} "
          f"ms/step, {k3[:1]} {by_class['K3'] / SEG_STEPS:.4f} ms/step")
    print(f"     device time per step: {breakdown(kern, SEG_STEPS)}")
    check(bool(k1) and bool(k3), f"the profiler showed no K1/K3 kernels of the graphs: {sorted(kern)[:10]}")
    # one more replayed chain: the K1 and K3 kernels the profiler saw run, against the counters over the same call
    seen, replayed, captures = profiled_kernel_counts(lambda: pipe(init=init[:SAMPLE_BATCH], generator=gen,
                                                                   num_inference_steps=SEG_STEPS, output_type="pt"))
    fwd = SEG_STEPS + captures  # and the warm-up forward of a capture, were there one
    ran = {"K1": sum(n for k, n in seen.items() if profiling.kernel_class(k) == "K1"),
           "K3": sum(n for k, n in seen.items() if profiling.kernel_class(k) == "K3")}
    check(ran == {"K1": GN_PER_FORWARD * fwd, "K3": ATTN_PER_FORWARD * fwd}
          and replayed["groupnorm_silu"] == ran["K1"] and replayed["attention"] == ran["K3"],
          f"a replayed {SEG_STEPS}-step chain: the profiler saw {ran}, the counters counted {replayed}, "
          f"{fwd} forwards want {GN_PER_FORWARD * fwd} K1 and {ATTN_PER_FORWARD * fwd} K3")
    print(f"   (d) a replayed {SEG_STEPS}-step chain at B={SAMPLE_BATCH}, profiled: the profiler saw {ran['K1']} K1 "
          f"and {ran['K3']} K3 kernels run ({fwd} forwards x {GN_PER_FORWARD} and x {ATTN_PER_FORWARD}), the "
          f"launch counters counted {replayed['groupnorm_silu']} and {replayed['attention']}")
    print(f"   phase 12 (a), (b), (d) took {time.perf_counter() - phase_t0:.1f} s; on {smi}")
    return [("segment mode", f"{want_fwd} UNet forwards ({len(captured)} capture warm-ups)", counts, want)]


def segment_measure(root: str, run: str, smi: str) -> list:
    """Phase 12 (c), in phase 8's scratch directory: ``--mode measure
    --sample_ep 0 --sample_segment 25`` on its run dir, after the real-image
    dump is deleted (the measure writes it again), with the launch counters
    and the PNG codec's counters set to 0 just before and read just after.
    Its PNGs byte for byte, and score.json's _ep0 keys, those of phase 8
    (b)'s unsegmented measure; the codec wrote the dump and the chunks and
    read them back. Returns its launch window."""
    subs = [os.path.join(run, "measure", "ep0", s) for s in ("clean_noclip", "backdoor_noclip")]

    def pngs():
        return {(d, f): open(os.path.join(d, f), "rb").read() for d in subs for f in sorted(os.listdir(d))}

    before = pngs()
    keys = ("FID_proxy_ep0_noclip", "MSE_ep0_noclip", "SSIM_ep0_noclip")
    scores = {k: read_json(os.path.join(run, "score.json"))[k] for k in keys}
    shutil.rmtree(os.path.join(root, "measure", "FAKE"))
    cwd = os.getcwd()
    native.reset_counts()
    forwards = 2 * -(-CLI_MEASURE_N // CLI_EVAL_BATCH) * CLI_STEPS
    try:
        os.chdir(root)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        segments.reset_captures()
        cli.main(["--mode", "measure", "--ckpt", run, "--sample_ep", "0", "--sample_segment", str(SEG_CLI),
                  "--gpu", "0"])
        wall = time.perf_counter() - t0
        captured = len(segments.captures())
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        os.chdir(cwd)
    codec = native.counts()
    after = pngs()
    now = {k: read_json(os.path.join(run, "score.json"))[k] for k in keys}
    check(after.keys() == before.keys() and all(after[k] == before[k] for k in before),
          f"phase 12 (c): {sum(after.get(k) != v for k, v in before.items())} of {len(before)} PNGs differ from "
          "the unsegmented measure's")
    check(now == scores, f"phase 12 (c): score.json {now}, unsegmented {scores}")
    chunks = 2 * -(-CLI_MEASURE_N // CLI_EVAL_BATCH)
    check(native.native_available() and codec["encoded"] >= 1 + chunks and codec["decoded"] >= 3,
          f"phase 12 (c): the PNG codec encoded {codec['encoded']} batches (the dump and {chunks} chunks) and "
          f"decoded {codec['decoded']} (the FID's two dirs and the MSE's): {native.pngio._library.error}")
    print(f"   (c) cli --mode measure --sample_ep 0 --sample_segment {SEG_CLI} ({CLI_MEASURE_N} + {CLI_MEASURE_N} "
          f"images, {CLI_STEPS} DDIM steps in segments of {SEG_CLI}, f32): {len(after)} PNGs byte for byte and "
          f"score.json {now} equal to the unsegmented measure's; the native PNG codec encoded {codec['encoded']} "
          f"batches (the real-image dump, written again, and the chunks) and decoded {codec['decoded']} (the "
          f"read-back); {captured} chain captured; {wall:.1f} s; on {smi}")
    want_fwd = forwards + captured
    return [("segment-mode measure", f"{want_fwd} UNet forwards ({captured} capture warm-up)", counts,
             scratch_launches(want_fwd))]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test runs only on a GPU", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    smi = phase_environment()
    gen = torch.Generator(dev).manual_seed(0)
    kernels = [phase_groupnorm(dev, gen), phase_groupnorm_backward(dev, gen), phase_attention(dev, gen),
               phase_bias_shift(dev, gen), phase_vq_nearest(dev, gen)]
    forwards, sampling = phase_slice(dev, smi)
    zoo_fwd, zoo = phase_zoo(dev, smi)
    steps, training, bare_ms = phase_train(dev, smi)
    loop_steps, loop_sampled, trainer_counts = phase_trainer(dev, smi, bare_ms)
    cli_steps, cli_sampled, cli_counts, segment_runs = phase_cli(dev, smi)
    latent_runs = (phase_latent(dev, smi) + phase_published(dev, smi) + phase_scaleout(dev, smi)
                   + phase_segments(dev, smi) + segment_runs)

    for path, n, counts, want in (
        ("sampling", f"{forwards} UNet forwards", sampling, scratch_launches(forwards)),
        ("sampler zoo", f"{zoo_fwd} UNet forwards", zoo, scratch_launches(zoo_fwd)),
        ("training", f"{steps} train steps", training, scratch_launches(steps, steps)),
        ("trainer", f"{loop_steps} train steps and {loop_sampled} sampling forwards", trainer_counts,
         scratch_launches(loop_steps + loop_sampled, loop_steps)),
        ("CLI and ANP", f"{cli_steps} train and ANP steps and {cli_sampled} sampling forwards", cli_counts,
         scratch_launches(cli_steps + cli_sampled, cli_steps)),
        *latent_runs,
    ):
        print(f"launch counts over the {path} path ({n} on the card): "
              + ", ".join(f"{k}={v}" for k, v in counts.items()))
        check(counts == want and counts["groupnorm_silu"] > 0, f"{path} launches {counts}, want {want}")
    for k in kernels:
        k["launches"] = (sampling[k["name"]] + zoo[k["name"]] + training[k["name"]] + trainer_counts[k["name"]]
                         + cli_counts[k["name"]] + sum(counts[k["name"]] for _, _, counts, _ in latent_runs))
    print(f"chip_smoke: every check passed in {time.perf_counter() - t0:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--scaleout-rank"]:  # one rank of phase 11 (b) or (c), started by phase_scaleout
        scaleout_rank(*sys.argv[2:3], int(sys.argv[3]), *sys.argv[4:7])
        sys.exit(0)
    sys.exit(main())
