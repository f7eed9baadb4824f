from baddiffusion_tpu_torch.training.checkpoint import (
    ep_model_path,
    finish_async_saves,
    has_trainer_state,
    load_trainer_state,
    save_checkpoint,
    save_trainer_state,
)
from baddiffusion_tpu_torch.training.ema import EMAState, ema_decay, ema_init, ema_update
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
from baddiffusion_tpu_torch.training.trainer import sample_grids, train_loop

__all__ = [
    "AdamState",
    "EMAState",
    "Optimizer",
    "TrainState",
    "TrainStep",
    "constant_schedule_with_warmup",
    "cosine_schedule_with_warmup",
    "cosine_with_restarts_schedule_with_warmup",
    "create_train_state",
    "ema_decay",
    "ema_init",
    "ema_update",
    "ep_model_path",
    "finish_async_saves",
    "has_trainer_state",
    "linear_schedule_with_warmup",
    "load_trainer_state",
    "make_optimizer",
    "make_train_step",
    "polynomial_schedule_with_warmup",
    "sample_grids",
    "save_checkpoint",
    "save_trainer_state",
    "train_loop",
]
