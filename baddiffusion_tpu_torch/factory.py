"""The scheduler half of the factory (port of the scheduler part of
``baddiffusion_tpu/factory.py``): the scheduler names of
``DiffuserModelSched``, each with its scheduler (T = 1000, β 1e-4 → 0.02
linear) and pipeline kind, and the pipeline that kind gets. The solver
family runs through the generic pipeline with a per-step clip when
``clip_sample`` is on (the reference's modified PNDMPipeline).

Model loading (``get_model_sched``, ``get_pretrained``, the hub aliases) is
not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

from baddiffusion_tpu_torch import schedulers as S
from baddiffusion_tpu_torch.pipelines.pipeline import DiffusionPipeline


class DiffuserModelSched:
    CLIP_SAMPLE_DEFAULT = False

    DDPM_SCHED = "DDPM-SCHED"
    DDIM_SCHED = "DDIM-SCHED"
    DPM_SOLVER_PP_O1_SCHED = "DPM_SOLVER_PP_O1-SCHED"
    DPM_SOLVER_O1_SCHED = "DPM_SOLVER_O1-SCHED"
    DPM_SOLVER_PP_O2_SCHED = "DPM_SOLVER_PP_O2-SCHED"
    DPM_SOLVER_O2_SCHED = "DPM_SOLVER_O2-SCHED"
    DPM_SOLVER_PP_O3_SCHED = "DPM_SOLVER_PP_O3-SCHED"
    DPM_SOLVER_O3_SCHED = "DPM_SOLVER_O3-SCHED"
    UNIPC_SCHED = "UNIPC-SCHED"
    PNDM_SCHED = "PNDM-SCHED"
    DEIS_SCHED = "DEIS-SCHED"
    HEUN_SCHED = "HEUN-SCHED"
    LMSD_SCHED = "LMSD-SCHED"
    LDM_SCHED = "LDM-SCHED"
    SCORE_SDE_VE_SCHED = "SCORE-SDE-VE-SCHED"


T, BETA_START, BETA_END = 1000, 0.0001, 0.02

PIPELINE_DEFAULT_STEPS = {"ddpm": 1000, "ddim": 50, "solver": 50, "sde": 2000, "karras": 50}
PIPELINE_HF_CLASS = {
    "ddpm": "DDPMPipeline",
    "ddim": "DDIMPipeline",
    "solver": "PNDMPipeline",
    "sde": "ScoreSdeVePipeline",
    "karras": "KarrasVePipeline",
}


def _sched_spec(name: str) -> Tuple[Callable[[bool], S.ConfigurableScheduler], str]:
    """name -> (scheduler from clip_sample, pipeline kind)."""
    common = dict(num_train_timesteps=T, beta_start=BETA_START, beta_end=BETA_END)

    def dpm(order, pp):
        algorithm = "dpmsolver++" if pp else "dpmsolver"
        return lambda clip: S.DPMSolverMultistepScheduler(
            S.DPMSolverConfig(solver_order=order, algorithm_type=algorithm, **common))

    names = DiffuserModelSched
    table = {
        names.DDPM_SCHED: (lambda clip: S.DDPMScheduler(S.DDPMConfig(clip_sample=clip, **common)), "ddpm"),
        names.DDIM_SCHED: (lambda clip: S.DDIMScheduler(S.DDIMConfig(clip_sample=clip, **common)), "ddim"),
        names.DPM_SOLVER_PP_O1_SCHED: (dpm(1, True), "solver"),
        names.DPM_SOLVER_O1_SCHED: (dpm(1, False), "solver"),
        names.DPM_SOLVER_PP_O2_SCHED: (dpm(2, True), "solver"),
        names.DPM_SOLVER_O2_SCHED: (dpm(2, False), "solver"),
        names.DPM_SOLVER_PP_O3_SCHED: (dpm(3, True), "solver"),
        names.DPM_SOLVER_O3_SCHED: (dpm(3, False), "solver"),
        names.UNIPC_SCHED: (lambda clip: S.UniPCMultistepScheduler(S.UniPCConfig(**common)), "solver"),
        names.PNDM_SCHED: (lambda clip: S.PNDMScheduler(S.PNDMConfig(**common)), "solver"),
        names.DEIS_SCHED: (lambda clip: S.DEISMultistepScheduler(S.DEISConfig(**common)), "solver"),
        names.HEUN_SCHED: (lambda clip: S.HeunDiscreteScheduler(S.HeunConfig(**common)), "solver"),
        names.LMSD_SCHED: (lambda clip: S.LMSDiscreteScheduler(S.LMSConfig(**common)), "solver"),
        names.SCORE_SDE_VE_SCHED: (lambda clip: S.ScoreSdeVeScheduler(S.ScoreSdeVeConfig()), "sde"),
    }
    if name not in table:
        raise NotImplementedError(f"scheduler {name!r}")
    return table[name]


def _make_get_pipeline(model, kind: str, clip_sample: Optional[bool]):
    """``get_pipeline(scheduler, **kwargs)``: the pipeline of ``kind`` around
    ``model``; ``kwargs`` go to ``DiffusionPipeline`` (``device``,
    ``compute_dtype``)."""
    clip_each_step = 1.0 if kind == "solver" and clip_sample else None

    def get_pipeline(scheduler, **kwargs) -> DiffusionPipeline:
        return DiffusionPipeline(
            model,
            scheduler,
            clip_each_step=clip_each_step,
            default_inference_steps=PIPELINE_DEFAULT_STEPS[kind],
            hf_class_name=PIPELINE_HF_CLASS[kind],
            **kwargs,
        )

    return get_pipeline
