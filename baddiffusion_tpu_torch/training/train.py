"""The backdoor train step (port of ``baddiffusion_tpu/training/train.py``).

One step: uint8 batch → ``poison_batch`` → t ∼ U[0, T) and ε ∼ N(0, I) →
``q_sample_backdoor`` → UNet forward and backward → ``reduce_loss`` → clip the
gradients' global norm to 1.0 → Adam with the LR schedule. Parameters live in
f32; the UNet computes in its ``dtype`` (bf16 for speed); the loss and the
gradients reduce in f32. With ``grad_accum=k`` the batch is k micro-batches
whose gradients are summed, then divided by k, as the JAX ``lax.scan`` does.

Under a recording profiler a step opens the spans ``train.step`` (whole),
``train.forward`` and ``train.backward`` (each micro-batch) and
``optim.update`` (the mean over the micro-batches, on several ranks the
gradients' reduction, the clip and Adam; ``utils/profiling.span``).

Where the JAX step is one pure jitted function, this one updates the state in
place (the parameters, the Adam moments and the step count) and returns it,
which spares a second copy of the parameters and moments. The draws of t and
ε come from an explicit ``torch.Generator``, or are handed in (``timesteps``,
``noise``) so that a test can give the step JAX's own draws. As in the JAX
step, the model is deterministic (``model.apply`` with no dropout RNG): a
config's dropout never fires.

On several ranks (``layout``, a ``parallel.ParallelLayout``) the step is
the one-rank step on the global batch, up to the order of a sum. Each rank
is handed its rows of the global batch (``layout.batch``: rows
``[r·m/W, (r+1)·m/W)`` of each micro-batch of m rows) and draws t and ε for
the whole micro-batch in the one-rank order, keeping its rows, so every
rank's generator stays in step with the one-rank one. The loss and the
gradients are averaged over the data ranks before the clip and Adam; the
stored shards of a split layout are gathered before the forward and their
gradients reduce-scattered after the backward.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from baddiffusion_tpu_torch.attack.loss import backdoor_loss
from baddiffusion_tpu_torch.data.poison import poison_batch
from baddiffusion_tpu_torch.device import DeviceLike, resolve_device
from baddiffusion_tpu_torch.parallel.distributed import take_rows
from baddiffusion_tpu_torch.parallel.layout import ParallelLayout
from baddiffusion_tpu_torch.training.optim import AdamState, Optimizer
from baddiffusion_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class TrainState:
    """``params`` are the model's own trainable parameters, by name (in a
    split layout, this rank's shards of them: ``parallel.place_train_state``);
    the poisoning constants are f32 HWC tensors on the model's device."""

    step: int
    params: Dict[str, torch.nn.Parameter]
    opt_state: AdamState
    trigger: torch.Tensor
    target: torch.Tensor
    mask: torch.Tensor


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def create_train_state(model: torch.nn.Module, optimizer: Optimizer, trigger, target, mask) -> TrainState:
    params = {name: p for name, p in model.named_parameters() if p.requires_grad}
    device = _model_device(model)

    def const(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(device)

    return TrainState(
        step=0,
        params=params,
        opt_state=optimizer.init(list(params.values())),
        trigger=const(trigger),
        target=const(target),
        mask=const(mask),
    )


class TrainStep:
    """``step(state, image_u8 [B,H,W,C] uint8, is_clean [B] bool, generator,
    timesteps=None, noise=None) -> (state, {"loss", "grad_norm"})``. The
    metrics are 0-dim f32 tensors on the device (reading them waits for it);
    ``grad_norm`` is the norm before the clip. ``timesteps`` ``[B]`` and
    ``noise`` ``[B,H,W,C]`` replace the generator's draws; the generator may
    be None when both are given. With a ``layout``, ``image_u8`` and
    ``is_clean`` are this rank's rows and ``timesteps``/``noise`` the global
    batch's; the metrics are the global values, the same on every rank."""

    def __init__(self, model, optimizer: Optimizer, num_train_timesteps: int, alphas, alphas_cumprod,
                 loss_type: str, grad_accum: int, vmin: float, vmax: float, use_remat: bool,
                 device: torch.device, layout: Optional[ParallelLayout] = None):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        if layout is not None and layout.batch.grad_accum != grad_accum:
            raise ValueError(f"the layout splits {layout.batch.grad_accum} micro-batches, the step {grad_accum}")
        if _model_device(model).type != device.type:
            raise ValueError(f"the model's parameters are on {_model_device(model)}, the step runs on {device}")
        device = _model_device(model)
        self.model = model
        self.optimizer = optimizer
        self.num_train_timesteps = num_train_timesteps
        self.alphas = torch.as_tensor(np.asarray(alphas), dtype=torch.float32).to(device)
        self.alphas_cumprod = torch.as_tensor(np.asarray(alphas_cumprod), dtype=torch.float32).to(device)
        self.loss_type = loss_type
        self.grad_accum = grad_accum
        self.vmin, self.vmax = vmin, vmax
        self.use_remat = use_remat
        self.device = device
        self.layout = layout
        # this rank's place among the data ranks: draws are made for all of them
        self.data_index, self.data_count = (0, 1) if layout is None else (layout.batch.index, layout.batch.count)

    def _model_fn(self, x, t):
        if self.use_remat:  # recompute the UNet forward during backprop: FLOPs for memory
            return checkpoint(self.model, x, t, use_reentrant=False)
        return self.model(x, t)

    def loss(self, state: TrainState, image_u8: torch.Tensor, is_clean: torch.Tensor,
             generator: Optional[torch.Generator], timesteps=None, noise=None) -> torch.Tensor:
        """The loss of one micro-batch, with its autograd graph (no backward).
        The model runs as the JAX step runs it, deterministic: no dropout,
        whatever its config's rate. A model left in train mode is put back in
        eval mode, which is where it samples from too."""
        if self.model.training:
            self.model.eval()
        _, R, x_start = poison_batch(image_u8, is_clean, state.trigger, state.target, state.mask, self.vmin, self.vmax)
        b = image_u8.shape[0]
        if (timesteps is None or noise is None) and generator is None:
            raise ValueError("pass a generator, or both timesteps and noise")
        # the draws of the whole micro-batch (every data rank's rows), then this rank's
        rows = slice(self.data_index * b, (self.data_index + 1) * b)
        if timesteps is None:
            timesteps = torch.randint(0, self.num_train_timesteps, (b * self.data_count,), generator=generator,
                                      device=self.device)[rows]
        if noise is None:
            noise = torch.randn((b * self.data_count,) + tuple(x_start.shape[1:]), generator=generator,
                                device=self.device)[rows]
        return backdoor_loss(self._model_fn, self.alphas, self.alphas_cumprod, x_start, R,
                             timesteps, noise, self.loss_type)

    def __call__(self, state: TrainState, image_u8, is_clean, generator: Optional[torch.Generator],
                 timesteps=None, noise=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with span("train.step"):
            image_u8 = torch.as_tensor(image_u8).to(self.device)
            is_clean = torch.as_tensor(is_clean).to(self.device)
            k = self.grad_accum
            b = image_u8.shape[0]
            if b % k:
                raise ValueError(f"batch {b} is not a multiple of grad_accum {k}")
            micro = b // k
            if timesteps is not None:
                timesteps = take_rows(torch.as_tensor(timesteps).to(self.device, torch.long), self.data_index,
                                      self.data_count, k)
            if noise is not None:
                noise = take_rows(torch.as_tensor(noise).to(self.device, torch.float32), self.data_index,
                                  self.data_count, k)
            lay = self.layout
            params = list(state.params.values())
            working = params
            if lay is not None and lay.sharded:
                lay.gather_params(state.params)
                working = lay.working
            for p in working:
                p.grad = None
            loss_sum = torch.zeros((), device=self.device)
            for i in range(k):
                rows = slice(i * micro, (i + 1) * micro)
                with span("train.forward"):
                    loss = self.loss(state, image_u8[rows], is_clean[rows], generator,
                                     None if timesteps is None else timesteps[rows],
                                     None if noise is None else noise[rows])
                with span("train.backward"):
                    loss.backward()
                loss_sum += loss.detach()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in working]
            loss, norm = loss_sum / k, None
            with span("optim.update"):
                if k > 1:
                    torch._foreach_div_(grads, float(k))
                if lay is not None:
                    grads = lay.reduce_grads(grads)
                    loss = lay.reduce_mean(loss)
                    norm = lay.grad_norm(grads)
                grad_norm = self.optimizer.update(grads, state.opt_state, params, norm=norm)
            state.step += 1
            return state, {"loss": loss, "grad_norm": grad_norm}


def make_train_step(
    model: torch.nn.Module,
    optimizer: Optimizer,
    num_train_timesteps: int,
    alphas,
    alphas_cumprod,
    loss_type: str = "l2",
    grad_accum: int = 1,
    vmin: float = -1.0,
    vmax: float = 1.0,
    use_remat: bool = False,
    device: DeviceLike = None,
    layout: Optional[ParallelLayout] = None,
) -> Callable:
    """Build the train step on ``device`` (CUDA unless the caller asks
    otherwise; raises without a GPU). The model must already be there: build
    it with the same ``device``. ``layout`` (the counterpart of the JAX
    step's ``mesh`` and ``state_shardings``) runs it as one rank of several."""
    return TrainStep(model, optimizer, num_train_timesteps, alphas, alphas_cumprod, loss_type, grad_accum,
                     vmin, vmax, use_remat, resolve_device(device), layout)
