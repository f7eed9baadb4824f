from baddiffusion_tpu_torch.training.optim import (
    AdamState,
    Optimizer,
    constant_schedule_with_warmup,
    cosine_schedule_with_warmup,
    cosine_with_restarts_schedule_with_warmup,
    linear_schedule_with_warmup,
    make_optimizer,
    polynomial_schedule_with_warmup,
)
from baddiffusion_tpu_torch.training.train import TrainState, TrainStep, create_train_state, make_train_step

__all__ = [
    "AdamState",
    "Optimizer",
    "TrainState",
    "TrainStep",
    "constant_schedule_with_warmup",
    "cosine_schedule_with_warmup",
    "cosine_with_restarts_schedule_with_warmup",
    "create_train_state",
    "linear_schedule_with_warmup",
    "make_optimizer",
    "make_train_step",
    "polynomial_schedule_with_warmup",
]
