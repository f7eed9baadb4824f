"""ANP (Adversarial Neuron Pruning), the backdoor defense (port of
``baddiffusion_tpu/defense/anp.py``).

The reference (``anp_model.py``, ``anp_util.py``, ``anp_defense.py``) wraps
every Conv2d as conv + a degenerate BatchNorm (statistics fixed at 0 and 1,
eps 0) whose affine γ/β are the only trainables; the defense *maximises* the
clean DDPM loss (loss = −p_losses with R = 0) with Adam over γ/β after a
clip of their gradients' global norm to 1.0, and clamps every γ/β to
±perturb_budget after each step; ``backdoor_mse`` compares the same
ε-prediction with the backdoor training target, as a diagnostic.

As in the JAX package, no module is rebuilt: a degenerate BatchNorm after a
conv is γ·(W∗x + b) + β, so the perturbation ``{conv name: {"gamma",
"beta"}}`` scales the conv's output channels and replaces its bias with
γ·b + β (``apply_perturb``). The UNet runs on the merged weights through
``torch.func.functional_call``; its own parameters stay frozen on the device
and take no gradient, so the step's backward carries the gradient to γ/β
through the activations alone (K2's dx path in every GroupNorm+SiLU).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from baddiffusion_tpu_torch.attack.loss import q_sample_backdoor, reduce_loss
from baddiffusion_tpu_torch.data.poison import poison_batch
from baddiffusion_tpu_torch.device import DeviceLike, resolve_device
from baddiffusion_tpu_torch.training.optim import AdamState, Optimizer

Perturb = Dict[str, Dict[str, torch.Tensor]]


def init_perturb(params: Dict[str, torch.Tensor]) -> Perturb:
    """γ = 1 for every 4-D conv weight's output channels, and β = 0 where the
    conv has a bias (β folds into the bias; a bias-less conv could not carry
    it). ``params`` is a state dict (or ``named_parameters``); the result is
    f32 on the parameters' device, in their order."""
    out: Perturb = {}
    for name, value in params.items():
        module, _, leaf = name.rpartition(".")
        if leaf == "weight" and value.dim() == 4:
            o = value.shape[0]
            out[module] = {"gamma": torch.ones(o, dtype=torch.float32, device=value.device)}
            if f"{module}.bias" in params:
                out[module]["beta"] = torch.zeros(o, dtype=torch.float32, device=value.device)
    return out


def apply_perturb(params: Dict[str, torch.Tensor], perturb: Perturb) -> Dict[str, torch.Tensor]:
    """The perturbed conv weights and biases: weight·γ over the output
    channels, bias·γ + β. Only those entries; the rest of ``params`` is
    unchanged."""
    out = {}
    for module, pt in perturb.items():
        gamma = pt["gamma"]
        weight = params[f"{module}.weight"]
        out[f"{module}.weight"] = weight * gamma.to(weight.dtype)[:, None, None, None]
        bias = params.get(f"{module}.bias")
        if bias is not None:
            beta = pt.get("beta")
            out[f"{module}.bias"] = bias * gamma.to(bias.dtype) + (0.0 if beta is None else beta.to(bias.dtype))
    return out


def perturb_leaves(perturb: Perturb) -> List[torch.Tensor]:
    """γ/β tensors in a fixed order (modules in the tree's order, γ then β):
    the optimizer's parameter list."""
    return [t for pt in perturb.values() for t in (pt["gamma"], pt.get("beta")) if t is not None]


@torch.no_grad()
def clip_perturb(perturb: Perturb, budget: Optional[float]) -> Perturb:
    """Clamp every γ/β to ±budget, in place (reference clip_weight,
    anp_defense.py:68-75); a budget of None or below 0 clamps nothing."""
    if budget is not None and budget >= 0:
        for t in perturb_leaves(perturb):
            t.clamp_(-budget, budget)
    return perturb


def perturbed_forward(model: torch.nn.Module, perturb: Perturb, x: torch.Tensor, t) -> torch.Tensor:
    """The model's forward on its weights merged with ``perturb``."""
    params = dict(model.named_parameters())
    return functional_call(model, apply_perturb(params, perturb), (x, t))


@torch.no_grad()
def perturbed_copy(model: torch.nn.Module, perturb: Perturb) -> torch.nn.Module:
    """A copy of ``model`` with the perturbation merged into its weights:
    what the per-epoch sampling and the export use."""
    twin = copy.deepcopy(model)
    merged = apply_perturb(dict(model.named_parameters()), perturb)
    for name, p in twin.named_parameters():
        if name in merged:
            p.copy_(merged[name])
    return twin


class ANPStep:
    """``step(perturb, opt_state, image_u8, is_clean, trigger, target, mask,
    generator, timesteps=None, noise=None) -> (perturb, opt_state,
    {"loss", "clean_mse", "backdoor_mse"})``. The batch is fully poisoned
    (clean rate 0, poison rate 1): the clean image is the q-sample's x₀ with
    R = 0, the trigger composite and the backdoor target only feed the
    diagnostic. γ/β are updated in place; the metrics are 0-dim f32 tensors
    on the device. t and ε come from ``generator`` (t first), or are handed
    in, as in the train step."""

    def __init__(self, model, optimizer: Optimizer, num_train_timesteps: int, alphas, alphas_cumprod,
                 perturb_budget: Optional[float], vmin: float, vmax: float, device: torch.device):
        params = list(model.parameters())
        if params[0].device.type != device.type:
            raise ValueError(f"the model's parameters are on {params[0].device}, the step runs on {device}")
        self.device = params[0].device
        model.requires_grad_(False)
        self.model = model.eval()
        self.optimizer = optimizer
        self.num_train_timesteps = num_train_timesteps
        self.alphas = torch.as_tensor(np.asarray(alphas), dtype=torch.float32).to(self.device)
        self.alphas_cumprod = torch.as_tensor(np.asarray(alphas_cumprod), dtype=torch.float32).to(self.device)
        self.perturb_budget = perturb_budget
        self.vmin, self.vmax = vmin, vmax

    def __call__(self, perturb: Perturb, opt_state: AdamState, image_u8, is_clean, trigger, target, mask,
                 generator: Optional[torch.Generator], timesteps=None, noise=None
                 ) -> Tuple[Perturb, AdamState, Dict[str, torch.Tensor]]:
        dev = self.device

        def const(a):
            return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a, dtype=torch.float32).to(dev)

        image_u8 = torch.as_tensor(image_u8).to(dev)
        is_clean = torch.as_tensor(is_clean).to(dev)
        image, R, tgt = poison_batch(image_u8, is_clean, const(trigger), const(target), const(mask),
                                     self.vmin, self.vmax)
        b = image_u8.shape[0]
        if (timesteps is None or noise is None) and generator is None:
            raise ValueError("pass a generator, or both timesteps and noise")
        if timesteps is None:
            timesteps = torch.randint(0, self.num_train_timesteps, (b,), generator=generator, device=dev)
        else:
            timesteps = torch.as_tensor(timesteps).to(dev, torch.long)
        if noise is None:
            noise = torch.randn(image.shape, generator=generator, device=dev)
        else:
            noise = torch.as_tensor(noise).to(dev, torch.float32)

        leaves = perturb_leaves(perturb)
        for t in leaves:
            t.requires_grad_(True)
        x_noisy, clean_target = q_sample_backdoor(self.alphas, self.alphas_cumprod, image, torch.zeros_like(image),
                                                  timesteps, noise)
        pred = perturbed_forward(self.model, perturb, x_noisy, timesteps)
        clean_loss = reduce_loss(pred, clean_target, "l2")
        loss = -clean_loss
        grads = list(torch.autograd.grad(loss, leaves))
        for t in leaves:
            t.requires_grad_(False)
        with torch.no_grad():
            _, bd_target = q_sample_backdoor(self.alphas, self.alphas_cumprod, tgt, R, timesteps, noise)
            backdoor_mse = reduce_loss(pred.detach(), bd_target, "l2")
        self.optimizer.update(grads, opt_state, leaves)
        clip_perturb(perturb, self.perturb_budget)
        return perturb, opt_state, {"loss": loss.detach(), "clean_mse": clean_loss.detach(),
                                    "backdoor_mse": backdoor_mse}


def make_anp_step(
    model: torch.nn.Module,
    optimizer: Optimizer,
    num_train_timesteps: int,
    alphas,
    alphas_cumprod,
    perturb_budget: Optional[float] = 4.0,
    vmin: float = -1.0,
    vmax: float = 1.0,
    device: DeviceLike = None,
) -> ANPStep:
    """Build the ANP step on ``device`` (CUDA unless the caller asks
    otherwise; the model must be there already). The model's own parameters
    are frozen (``requires_grad_(False)``): only γ/β move."""
    return ANPStep(model, optimizer, num_train_timesteps, alphas, alphas_cumprod, perturb_budget, vmin, vmax,
                   resolve_device(device))
