from baddiffusion_tpu_torch.schedulers.base import (
    SCHEDULER_CONFIG_NAME,
    ConfigurableScheduler,
    DiffusionSchedule,
    add_noise_common,
    load_scheduler,
    make_betas,
    pred_x0_from_model_output,
    scheduler_registry,
    spaced_timesteps,
    threshold_sample,
)
from baddiffusion_tpu_torch.schedulers.ddpm import DDPMConfig, DDPMScheduler, DDPMState
from baddiffusion_tpu_torch.schedulers.ddim import DDIMConfig, DDIMScheduler, DDIMState
from baddiffusion_tpu_torch.schedulers.dpmsolver import DPMSolverConfig, DPMSolverMultistepScheduler, DPMSolverState
from baddiffusion_tpu_torch.schedulers.unipc import UniPCConfig, UniPCMultistepScheduler, UniPCState
from baddiffusion_tpu_torch.schedulers.deis import DEISConfig, DEISMultistepScheduler, DEISState
from baddiffusion_tpu_torch.schedulers.pndm import PNDMConfig, PNDMScheduler, PNDMState
from baddiffusion_tpu_torch.schedulers.heun import HeunConfig, HeunDiscreteScheduler, HeunState
from baddiffusion_tpu_torch.schedulers.lms import LMSConfig, LMSDiscreteScheduler, LMSState
from baddiffusion_tpu_torch.schedulers.sde_ve import ScoreSdeVeConfig, ScoreSdeVeScheduler, ScoreSdeVeState
from baddiffusion_tpu_torch.schedulers.karras_ve import (
    KarrasVeConfig,
    KarrasVeScheduler,
    KarrasVeState,
    sample_karras_ve,
)

__all__ = [
    "SCHEDULER_CONFIG_NAME",
    "ConfigurableScheduler",
    "DiffusionSchedule",
    "add_noise_common",
    "load_scheduler",
    "make_betas",
    "pred_x0_from_model_output",
    "scheduler_registry",
    "spaced_timesteps",
    "threshold_sample",
    "DDPMConfig",
    "DDPMScheduler",
    "DDPMState",
    "DDIMConfig",
    "DDIMScheduler",
    "DDIMState",
    "DPMSolverConfig",
    "DPMSolverMultistepScheduler",
    "DPMSolverState",
    "UniPCConfig",
    "UniPCMultistepScheduler",
    "UniPCState",
    "DEISConfig",
    "DEISMultistepScheduler",
    "DEISState",
    "PNDMConfig",
    "PNDMScheduler",
    "PNDMState",
    "HeunConfig",
    "HeunDiscreteScheduler",
    "HeunState",
    "LMSConfig",
    "LMSDiscreteScheduler",
    "LMSState",
    "ScoreSdeVeConfig",
    "ScoreSdeVeScheduler",
    "ScoreSdeVeState",
    "KarrasVeConfig",
    "KarrasVeScheduler",
    "KarrasVeState",
    "sample_karras_ve",
]
