"""What bf16 sampling costs in the scores, on a fixed checkpoint (port of the
JAX package's ``examples/bf16_drift.py``).

Samples ``n`` clean and ``n`` backdoor images with the checkpoint's f32
weights computing in f32, then in bf16 (``pipeline.compute_dtype``), from
the same inits and generators, and reports per dtype the backdoor MSE/SSIM
against the tiled target, the clean branch's FID proxy against FAKE images,
imgs/s, and the bf16-minus-f32 deltas. The inits are the JAX script's
(``normal(PRNGKey(0))``, bit for bit); chunk i draws from
``chunk_generator(0, i)`` in both dtypes.

The decision rule the JAX package records: bf16 is admissible for the
measure while |ΔMSE| stays orders of magnitude below the gap between a
planted backdoor (MSE about 1e-3) and none (about 0.2).

    python -m baddiffusion_tpu_torch.examples.bf16_drift [--ckpt attack_demo_out] [--n 256]
        [--steps 1000] [--batch 128] [--out DIR] [--gpu cpu]

Writes ``drift.json`` and the images into ``--out``
(``torch_examples_out/bf16_drift`` by default).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import numpy as np
import torch

from baddiffusion_tpu_torch.config import device_from_gpu
from baddiffusion_tpu_torch.data import DatasetLoader
from baddiffusion_tpu_torch.device import DeviceLike, resolve_device
from baddiffusion_tpu_torch.metrics import fid as fid_fn
from baddiffusion_tpu_torch.metrics import mse, ssim
from baddiffusion_tpu_torch.metrics._prng import normal, prng_key
from baddiffusion_tpu_torch.pipelines import DiffusionPipeline, batch_sampling
from baddiffusion_tpu_torch.utils.image import save_images

DEFAULT_OUT = os.path.join("torch_examples_out", "bf16_drift")


def run(ckpt: str = "attack_demo_out", n: int = 256, steps: int = 1000, batch: int = 128, trigger: str = "BOX_14",
        target: str = "CORNER", out: str = DEFAULT_OUT, device: DeviceLike = None) -> Dict:
    dev = resolve_device(device)
    pipe = DiffusionPipeline.from_pretrained(ckpt, device=dev)
    size, ch = pipe.unet.config.sample_size, pipe.unet.config.in_channels
    dsl = DatasetLoader(DatasetLoader.FAKE, image_size=size, channel=ch, batch_size=batch, fake_size=max(n, 256))
    dsl.set_poison(trigger, target, poison_rate=0.3).prepare_dataset()
    target01 = np.clip(dsl.target / 2.0 + 0.5, 0, 1)
    init = normal(prng_key(0), (n, size, size, ch))
    binit = init + dsl.trigger[None]

    os.makedirs(out, exist_ok=True)
    real_dir = os.path.join(out, "real")
    if not os.path.isdir(real_dir):
        save_images(dsl.real_image_sample(n).astype(np.float32) / 255.0, real_dir)

    results = {}
    for tag, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        pipe.compute_dtype = dtype
        t0 = time.perf_counter()
        clean = batch_sampling(n, pipe, init=init, max_batch_n=batch, seed=0, num_inference_steps=steps)
        bd = batch_sampling(n, pipe, init=binit, max_batch_n=batch, seed=0, num_inference_steps=steps)
        dt = time.perf_counter() - t0
        clean_dir = os.path.join(out, f"clean_{tag}")
        save_images(clean, clean_dir)
        tiled = np.ascontiguousarray(np.broadcast_to(target01, bd.shape)).astype(np.float32)
        results[tag] = {
            "MSE": float(mse(bd, tiled, device=dev)),
            "SSIM": float(ssim(bd, tiled, device=dev)),
            "FID_proxy": float(fid_fn([real_dir, clean_dir], device=dev)),
            "imgs_per_sec": round(2 * n / dt, 2),
        }
        print(tag, results[tag], flush=True)

    deltas = {k: results["bf16"][k] - results["f32"][k] for k in ("MSE", "SSIM", "FID_proxy")}
    summary = {"f32": results["f32"], "bf16": results["bf16"], "delta_bf16_minus_f32": deltas, "n": n,
               "steps": steps, "ckpt": ckpt,
               "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    with open(os.path.join(out, "drift.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary), flush=True)
    return summary


def parser() -> argparse.ArgumentParser:
    """The JAX script's flags and defaults (outputs under git-ignored
    directories), and ``--gpu``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", type=str, default="attack_demo_out")
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--trigger", type=str, default="BOX_14")
    p.add_argument("--target", type=str, default="CORNER")
    p.add_argument("--out", type=str, default=DEFAULT_OUT)
    p.add_argument("--gpu", type=str, default=None, help="N for cuda:N, 'cpu' for the plain PyTorch path")
    return p


def main(argv=None) -> Dict:
    args = parser().parse_args(argv)
    return run(args.ckpt, args.n, args.steps, args.batch, args.trigger, args.target, args.out,
               device=device_from_gpu(args.gpu))


if __name__ == "__main__":
    main()
