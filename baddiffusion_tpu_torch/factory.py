"""Model, scheduler and pipeline factory, the reference's
``DiffuserModelSched`` surface (port of ``baddiffusion_tpu/factory.py``).

- The scheduler names of ``DiffuserModelSched``, each with its scheduler
  (T = 1000, β 1e-4 → 0.02 linear) and pipeline kind, and the pipeline that
  kind gets. The solver family runs through the generic pipeline with a
  per-step clip when ``clip_sample`` is on (the reference's modified
  PNDMPipeline).
- ``get_model_sched``: the scratch UNet (the reference's default
  architecture), or a ``*-DEFAULT`` alias's architecture with fresh weights.
- ``get_pretrained`` / ``get_trained``: an HF-layout pipeline directory, with
  the pipeline kind inferred from the stored scheduler's class. Checkpoint
  aliases map to hub ids, which resolve offline only (a local directory or
  the local HF cache).

Each returns ``(model, scheduler, get_pipeline)``: the UNet holds its own
weights, so where the JAX package returns ``params`` beside the model, the
port has none. ``get_pipeline(scheduler, unet=None, **kwargs)`` builds the
``DiffusionPipeline`` around ``unet`` (default: the model) with ``kwargs``
(``device``, ``compute_dtype``). The model is made on ``device``, CUDA
unless the caller asks otherwise. Not ported: LDM checkpoints (the VQ-VAE
and the latent pipeline, ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional, Tuple

import torch

from baddiffusion_tpu_torch import schedulers as S
from baddiffusion_tpu_torch.device import DeviceLike
from baddiffusion_tpu_torch.models.unet2d import DEFAULT_SCRATCH_CONFIG, UNet2DConfig, UNet2DModel
from baddiffusion_tpu_torch.pipelines.pipeline import DiffusionPipeline


class DiffuserModelSched:
    CLIP_SAMPLE_DEFAULT = False
    MODEL_DEFAULT = "DEFAULT"
    DDPM_CIFAR10_DEFAULT = "DDPM-CIFAR10-DEFAULT"
    DDPM_CELEBA_HQ_DEFAULT = "DDPM-CELEBA-HQ-DEFAULT"
    DDPM_CHURCH_DEFAULT = "DDPM-CHURCH-DEFAULT"
    DDPM_BEDROOM_DEFAULT = "DDPM-BEDROOM-DEFAULT"
    LDM_CELEBA_HQ_DEFAULT = "LDM-CELEBA-HQ-DEFAULT"

    DDPM_CIFAR10_32 = "DDPM-CIFAR10-32"
    DDPM_CELEBA_HQ_256 = "DDPM-CELEBA-HQ-256"
    DDPM_CHURCH_256 = "DDPM-CHURCH-256"
    DDPM_BEDROOM_256 = "DDPM-BEDROOM-256"
    LDM_CELEBA_HQ_256 = "LDM-CELEBA-HQ-256"

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


HUB_ALIASES = {
    DiffuserModelSched.DDPM_CIFAR10_32: "google/ddpm-cifar10-32",
    DiffuserModelSched.DDPM_CELEBA_HQ_256: "google/ddpm-ema-celebahq-256",
    DiffuserModelSched.DDPM_CHURCH_256: "google/ddpm-ema-church-256",
    DiffuserModelSched.DDPM_BEDROOM_256: "google/ddpm-ema-bedroom-256",
    DiffuserModelSched.LDM_CELEBA_HQ_256: "CompVis/ldm-celebahq-256",
}
# *-DEFAULT: a pretrained checkpoint's architecture with fresh weights
DEFAULT_ALIASES = {
    DiffuserModelSched.DDPM_CIFAR10_DEFAULT: DiffuserModelSched.DDPM_CIFAR10_32,
    DiffuserModelSched.DDPM_CELEBA_HQ_DEFAULT: DiffuserModelSched.DDPM_CELEBA_HQ_256,
    DiffuserModelSched.DDPM_CHURCH_DEFAULT: DiffuserModelSched.DDPM_CHURCH_256,
    DiffuserModelSched.DDPM_BEDROOM_DEFAULT: DiffuserModelSched.DDPM_BEDROOM_256,
}
# the pipeline kind of a checkpoint's stored scheduler class; every other class is a solver
STORED_SCHEDULER_KIND = {
    "DDPMScheduler": "ddpm",
    "DDIMScheduler": "ddim",
    "ScoreSdeVeScheduler": "sde",
    "KarrasVeScheduler": "karras",
}
TINY_ARCH_ENV = "BADDIFFUSION_TINY_ARCH"

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
    """``get_pipeline(scheduler, unet=None, **kwargs)``: the pipeline of
    ``kind`` around ``unet`` (default ``model``); ``kwargs`` go to
    ``DiffusionPipeline`` (``device``, ``compute_dtype``)."""
    clip_each_step = 1.0 if kind == "solver" and clip_sample else None

    def get_pipeline(scheduler, unet: Optional[UNet2DModel] = None, **kwargs) -> DiffusionPipeline:
        return DiffusionPipeline(
            model if unet is None else unet,
            scheduler,
            clip_each_step=clip_each_step,
            default_inference_steps=PIPELINE_DEFAULT_STEPS[kind],
            hf_class_name=PIPELINE_HF_CLASS[kind],
            **kwargs,
        )

    return get_pipeline


def resolve_checkpoint_path(ckpt: str) -> str:
    """Alias → hub id → local directory. Offline: a hub id resolves only when
    it is in the local HF cache; otherwise a clear error says so."""
    hub_id = HUB_ALIASES.get(ckpt, ckpt)
    if os.path.isdir(hub_id):
        return hub_id
    try:
        from huggingface_hub import snapshot_download

        return snapshot_download(hub_id, local_files_only=True)
    except Exception as exc:  # not installed, not cached, or not a repo id: all one answer
        raise FileNotFoundError(
            f"checkpoint {ckpt!r} → {hub_id!r}: not a local directory and not in the "
            "HF cache. This environment has no network egress; pre-stage the "
            "checkpoint directory (HF layout: model_index.json + unet/ + scheduler/)."
        ) from exc


def scratch_config(image_size: int, channels: int):
    """The scratch UNet's config at ``image_size`` and ``channels``. With
    ``BADDIFFUSION_TINY_ARCH=1`` (a test hook, as in the JAX package) a
    two-level 8/16-channel UNet, so that the whole CLI runs on the CPU."""
    base = DEFAULT_SCRATCH_CONFIG
    if os.environ.get(TINY_ARCH_ENV) == "1":
        base = dataclasses.replace(
            DEFAULT_SCRATCH_CONFIG,
            layers_per_block=1,
            block_out_channels=(8, 16),
            down_block_types=("DownBlock2D", "AttnDownBlock2D"),
            up_block_types=("AttnUpBlock2D", "UpBlock2D"),
            norm_num_groups=4,
            attention_head_dim=4,
        )
    return dataclasses.replace(base, sample_size=image_size, in_channels=channels, out_channels=channels)


def get_model_sched(
    image_size: int,
    channels: int,
    model_type: str = DiffuserModelSched.MODEL_DEFAULT,
    noise_sched_type: Optional[str] = None,
    clip_sample: Optional[bool] = None,
    rng_seed: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    device: DeviceLike = None,
):
    """A model with fresh weights (reference model.py:645-698), drawn from a
    CPU generator seeded ``rng_seed``, computing in ``dtype`` on ``device``:
    the scratch UNet, or a ``*-DEFAULT`` alias's architecture and scheduler.
    Returns ``(model, scheduler, get_pipeline)``."""
    clip = DiffuserModelSched.CLIP_SAMPLE_DEFAULT if clip_sample is None else clip_sample
    generator = torch.Generator().manual_seed(rng_seed)
    if model_type == DiffuserModelSched.MODEL_DEFAULT:
        config = scratch_config(image_size, channels)
        make_sched, kind = _sched_spec(noise_sched_type or DiffuserModelSched.DDPM_SCHED)
        scheduler = make_sched(clip)
    elif model_type in DEFAULT_ALIASES:
        path, scheduler, kind = _pretrained_scheduler(DEFAULT_ALIASES[model_type], clip_sample, noise_sched_type)
        config = UNet2DConfig.load(path, subfolder="unet")
    else:
        raise NotImplementedError(f"model_type {model_type!r}")
    model = UNet2DModel(config, device=device, generator=generator, dtype=dtype)
    return model, scheduler, _make_get_pipeline(model, kind, clip)


def _pretrained_scheduler(ckpt: str, clip_sample: Optional[bool], noise_sched_type: Optional[str]):
    """(local path, scheduler, pipeline kind) of a checkpoint. Without
    ``noise_sched_type`` the checkpoint's own scheduler, with the clip
    override pushed into its config, and the kind of its class."""
    path = resolve_checkpoint_path(ckpt)
    index_path = os.path.join(path, "model_index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)
        if index.get("_class_name") == "LDMPipeline" or "vqvae" in index:
            raise NotImplementedError(
                f"{ckpt!r} is an LDM checkpoint: the VQ-VAE and the latent pipeline are not ported yet "
                "(ROADMAP Queue 1 item 10)")
    clip = DiffuserModelSched.CLIP_SAMPLE_DEFAULT if clip_sample is None else clip_sample
    if noise_sched_type is not None:
        make_sched, kind = _sched_spec(noise_sched_type)
        return path, make_sched(clip), kind
    scheduler = S.load_scheduler(path, subfolder="scheduler")
    if hasattr(scheduler.config, "clip_sample") and clip_sample is not None:
        scheduler = type(scheduler)(dataclasses.replace(scheduler.config, clip_sample=clip))
    # a ScoreSdeVe checkpoint keeps its 2000-step default and its model_index
    # class (a 'solver' fallback would run VE sampling at 50 steps and label
    # the export PNDMPipeline)
    return path, scheduler, STORED_SCHEDULER_KIND.get(scheduler.hf_class_name, "solver")


def get_pretrained(
    ckpt: str,
    clip_sample: Optional[bool] = None,
    noise_sched_type: Optional[str] = None,
    dtype: torch.dtype = torch.bfloat16,
    device: DeviceLike = None,
):
    """A trained or pretrained HF-layout checkpoint (reference
    model.py:577-643,700-729) on ``device``, computing in ``dtype``, with the
    checkpoint's scheduler or ``noise_sched_type``'s. Returns ``(model,
    scheduler, get_pipeline)``."""
    from baddiffusion_tpu_torch.io import load_unet

    path, scheduler, kind = _pretrained_scheduler(ckpt, clip_sample, noise_sched_type)
    model = load_unet(path, subfolder="unet", device=device, dtype=dtype)
    clip = DiffuserModelSched.CLIP_SAMPLE_DEFAULT if clip_sample is None else clip_sample
    return model, scheduler, _make_get_pipeline(model, kind, clip)


get_trained = get_pretrained
