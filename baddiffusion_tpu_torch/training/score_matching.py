"""The VE denoising-score-matching train step (port of
``baddiffusion_tpu/training/score_matching.py``).

A score model for the SDE-VE sampler, trained over the scheduler's own
geometric σ ladder (Song & Ermon):

    x̃ = x + σ·z,   z ∼ N(0, I),   σ ∼ the ladder
    loss = E ‖σ·s_θ(x̃, σ) + z‖²

The network's output is the score, conditioned on σ itself, as
``sample_sde_ve`` calls it. As ``TrainStep``: parameters live in f32, the
model computes in its ``dtype`` (bf16 for speed), the loss and gradients
reduce in f32, the gradients' global norm is clipped and Adam steps with the
port's ``Optimizer``; the state is updated in place. Every GroupNorm+SiLU
runs K1 forward and K2 backward, attention K3, through their autograd
Functions. The σ indices and z come from a ``torch.Generator``, or are handed
in (``sigma_idx``, ``z``) so that a test can give the step JAX's own draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from baddiffusion_tpu_torch.device import DeviceLike, resolve_device
from baddiffusion_tpu_torch.training.optim import AdamState, Optimizer


@dataclasses.dataclass
class ScoreTrainState:
    """``params`` are the model's own trainable parameters, by name."""

    step: int
    params: Dict[str, torch.nn.Parameter]
    opt_state: AdamState


def create_score_train_state(model: torch.nn.Module, optimizer: Optimizer) -> ScoreTrainState:
    params = {name: p for name, p in model.named_parameters() if p.requires_grad}
    return ScoreTrainState(step=0, params=params, opt_state=optimizer.init(list(params.values())))


class VETrainStep:
    """``step(state, image_u8 [B,H,W,C] uint8, generator=None, sigma_idx=None,
    z=None) -> (state, {"loss", "grad_norm"})``: 0-dim f32 tensors on the
    device, ``grad_norm`` before the clip. ``sigma_idx`` ``[B]`` (indices
    into the ladder) and ``z`` ``[B,H,W,C]`` replace the generator's draws."""

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer, discrete_sigmas, use_remat: bool,
                 device: torch.device):
        model_device = next(model.parameters()).device
        if model_device.type != device.type:
            raise ValueError(f"the model's parameters are on {model_device}, the step runs on {device}")
        self.model = model
        self.optimizer = optimizer
        self.sigmas = torch.tensor(np.asarray(discrete_sigmas, np.float32), device=model_device)
        self.use_remat = use_remat
        self.device = model_device

    def _model_fn(self, x, sigma):
        if self.use_remat:  # recompute the forward during backprop: FLOPs for memory
            return checkpoint(self.model, x, sigma, use_reentrant=False)
        return self.model(x, sigma)

    def loss(self, image_u8: torch.Tensor, generator: Optional[torch.Generator], sigma_idx=None,
             z=None) -> torch.Tensor:
        """The loss of one batch, with its autograd graph (no backward)."""
        if self.model.training:
            self.model.eval()
        x = image_u8.float() / 127.5 - 1.0
        b = x.shape[0]
        if (sigma_idx is None or z is None) and generator is None:
            raise ValueError("pass a generator, or both sigma_idx and z")
        if sigma_idx is None:
            sigma_idx = torch.randint(0, self.sigmas.shape[0], (b,), generator=generator, device=self.device)
        if z is None:
            z = torch.randn(x.shape, generator=generator, device=self.device)
        sigma = self.sigmas[sigma_idx].reshape(-1, 1, 1, 1)
        score = self._model_fn(x + sigma * z, self.sigmas[sigma_idx]).float()
        return torch.mean(torch.square(sigma * score + z))

    def __call__(self, state: ScoreTrainState, image_u8, generator: Optional[torch.Generator] = None,
                 sigma_idx=None, z=None) -> Tuple[ScoreTrainState, Dict[str, torch.Tensor]]:
        image_u8 = torch.as_tensor(image_u8).to(self.device)
        if sigma_idx is not None:
            sigma_idx = torch.as_tensor(sigma_idx).to(self.device, torch.long)
        if z is not None:
            z = torch.as_tensor(z).to(self.device, torch.float32)
        params = list(state.params.values())
        for p in params:
            p.grad = None
        loss = self.loss(image_u8, generator, sigma_idx, z)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        grad_norm = self.optimizer.update(grads, state.opt_state, params)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}


def make_ve_train_step(model: torch.nn.Module, optimizer: Optimizer, discrete_sigmas, use_remat: bool = False,
                       device: DeviceLike = None) -> Callable:
    """Build the VE-DSM step on ``device`` (CUDA unless the caller asks
    otherwise); ``discrete_sigmas`` is the ladder the sampler will use
    (``ScoreSdeVeState.discrete_sigmas``). The model must already be on
    ``device``."""
    return VETrainStep(model, optimizer, discrete_sigmas, use_remat, resolve_device(device))
