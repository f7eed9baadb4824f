"""The ANP defense against the attack demo's backdoor (port of the JAX
package's ``examples/defense_demo.py``).

Loads the backdoored pipeline ``attack_demo`` wrote (``factory.get_trained``
and its ``args.json``), measures the MSE of triggered sampling to the
backdoor target over 16 images (1000 DDPM steps), runs ANP (the
perturbation of every conv's output channels γ/β that maximises the clean
DDPM loss, within ±budget: Adam at a constant rate over 300 steps at batch
128, on the fully poisoned FAKE set), and measures the triggered MSE again
on the perturbed model. The initial noise is the JAX demo's, bit for bit.

    before ANP: backdoor MSE about 1e-4 (the trigger reliably gives the target)
    after ANP:  backdoor MSE rises sharply (the backdoor is broken)

Prints both and writes them to ``out``/result.json.

    python -m baddiffusion_tpu_torch.examples.defense_demo --ckpt attack_demo_out [--steps 300] [--gpu cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import torch

from baddiffusion_tpu_torch import factory
from baddiffusion_tpu_torch.config import device_from_gpu
from baddiffusion_tpu_torch.data import DatasetLoader
from baddiffusion_tpu_torch.defense import init_perturb, make_anp_step, perturb_leaves, perturbed_copy
from baddiffusion_tpu_torch.device import DeviceLike, resolve_device
from baddiffusion_tpu_torch.examples.attack_demo import initial_noise, target_scores
from baddiffusion_tpu_torch.training import make_optimizer
from baddiffusion_tpu_torch.training.trainer import step_seed


def triggered_mse(pipe, dsl: DatasetLoader, n: int = 16, steps: int = 1000) -> float:
    """MSE to the target of ``n`` images sampled from the JAX demo's noise
    plus the trigger."""
    noise = initial_noise(pipe.sample_shape(n))
    bd = pipe(init=noise + dsl.trigger[None], generator=torch.Generator(pipe.device).manual_seed(0),
              num_inference_steps=steps).images
    return target_scores(bd, None, dsl.target, pipe.device)["backdoor_mse"]


def run(ckpt: str, steps: int = 300, budget: float = 4.0, lr: float = 1e-4, *, out: str = "defense_demo_out",
        n: int = 16, sampling_steps: int = 1000, batch: int = 128, fake_size: int = 2048, log_every: int = 100,
        device: DeviceLike = None) -> Dict[str, float]:
    """ANP for ``steps`` steps on the run in ``ckpt``; returns (and writes to
    ``out``/result.json) the triggered MSE before and after, with
    ``anp_s`` and ``anp_steps_per_s``, the ANP loop's wall time."""
    dev = resolve_device(device)
    model, scheduler, get_pipeline = factory.get_trained(ckpt, device=dev)
    with open(os.path.join(ckpt, "args.json")) as f:
        meta = json.load(f)
    dsl = DatasetLoader(meta["dataset"], image_size=model.config.sample_size, batch_size=batch, fake_size=fake_size)
    dsl.set_poison(meta["trigger"], meta["target"], clean_rate=0.0, poison_rate=1.0)
    dsl.prepare_dataset()

    before = triggered_mse(get_pipeline(scheduler, device=dev), dsl, n, sampling_steps)
    print(f"backdoor_mse before ANP: {before:.6f}", flush=True)

    schedule = scheduler.create_state().schedule
    opt, _ = make_optimizer(lr, schedule="constant")
    perturb = init_perturb(dict(model.named_parameters()))
    opt_state = opt.init(perturb_leaves(perturb))
    step = make_anp_step(model, opt, scheduler.config.num_train_timesteps, schedule.alphas, schedule.alphas_cumprod,
                         perturb_budget=budget, device=dev)

    t0, gstep, epoch = time.perf_counter(), 0, 0
    while gstep < steps:
        for b in dsl.epoch_batches(epoch):
            perturb, opt_state, m = step(perturb, opt_state, b["image_u8"], b["is_clean"], dsl.trigger, dsl.target,
                                         dsl.mask, torch.Generator(dev).manual_seed(step_seed(1, gstep)))
            gstep += 1
            if gstep % log_every == 0:
                print(f"anp step {gstep}: clean_mse={float(m['clean_mse']):.4f} "
                      f"backdoor_mse_diag={float(m['backdoor_mse']):.4f} ({time.perf_counter() - t0:.0f}s)", flush=True)
            if gstep >= steps:
                break
        epoch += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    anp_s = time.perf_counter() - t0

    pruned = perturbed_copy(model, perturb)
    after = triggered_mse(get_pipeline(scheduler, unet=pruned, device=dev), dsl, n, sampling_steps)
    print(f"backdoor_mse after ANP:  {after:.6f}", flush=True)
    res = {"backdoor_mse_before": before, "backdoor_mse_after": after}
    print(json.dumps(res), flush=True)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "result.json"), "w") as f:
        json.dump(res, f)
    return dict(res, anp_s=anp_s, anp_steps_per_s=steps / anp_s if anp_s > 0 else float("nan"))


def main(argv=None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--budget", type=float, default=4.0)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--out", type=str, default="defense_demo_out")
    parser.add_argument("--gpu", type=str, default=None, help="N for cuda:N, 'cpu' for the plain PyTorch path")
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    res = run(args.ckpt, args.steps, args.budget, args.lr, out=args.out, device=device_from_gpu(args.gpu))
    print(f"defense_demo: {args.steps} ANP steps in {res['anp_s']:.1f} s ({res['anp_steps_per_s']:.3f} steps/s), "
          f"wall {time.perf_counter() - t0:.1f} s", flush=True)
    return res


if __name__ == "__main__":
    main()
