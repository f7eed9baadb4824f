from baddiffusion_tpu_torch.schedulers.base import (
    SCHEDULER_CONFIG_NAME,
    ConfigurableScheduler,
    DiffusionSchedule,
    add_noise_common,
    load_scheduler,
    make_betas,
    pred_x0_from_model_output,
    spaced_timesteps,
    threshold_sample,
)
from baddiffusion_tpu_torch.schedulers.ddpm import DDPMConfig, DDPMScheduler, DDPMState

__all__ = [
    "SCHEDULER_CONFIG_NAME",
    "ConfigurableScheduler",
    "DDPMConfig",
    "DDPMScheduler",
    "DDPMState",
    "DiffusionSchedule",
    "add_noise_common",
    "load_scheduler",
    "make_betas",
    "pred_x0_from_model_output",
    "spaced_timesteps",
    "threshold_sample",
]
