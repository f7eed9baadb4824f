"""DiffusionPipeline: a UNet + scheduler bundle with HF-layout IO (port of
the DDPM path of ``baddiffusion_tpu/pipelines/pipeline.py``).

``__call__`` keeps the JAX surface (``init=``, ``save_every_step``,
``capture_every``, ``start_from``, ``compute_dtype``): images come back as
NHWC float32 numpy arrays in [0, 1]. With ``compute_dtype`` the UNet runs on a
copy of its weights cast once per call (``UNet2DModel.compute_copy``: the
GroupNorm affines stay f32); the scheduler update stays f32.

Not ported yet: segmented chains, the device mesh, the SDE-VE and Karras-VE
engines, ``batch_sampling_save`` and the other schedulers.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from baddiffusion_tpu_torch.device import DeviceLike, resolve_device
from baddiffusion_tpu_torch.io import load_unet, save_unet
from baddiffusion_tpu_torch.models.unet2d import UNet2DModel
from baddiffusion_tpu_torch.pipelines.sampler import NoiseSource, sample_loop, to_images
from baddiffusion_tpu_torch.schedulers import load_scheduler

MODEL_INDEX_NAME = "model_index.json"


@dataclasses.dataclass
class PipelineOutput:
    """Images in [0, 1], NHWC; ``movie`` is the captured trajectory
    ``[frames, B, H, W, C]``."""

    images: np.ndarray
    movie: Optional[np.ndarray] = None


class DiffusionPipeline:
    """A (unet, scheduler) bundle on ``device`` (CUDA unless the caller asks
    otherwise; raises without a GPU)."""

    def __init__(
        self,
        unet: UNet2DModel,
        scheduler,
        clip_each_step: Optional[float] = None,
        default_inference_steps: int = 1000,
        hf_class_name: str = "DDPMPipeline",
        compute_dtype: Optional[torch.dtype] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.unet = unet.to(self.device).eval()
        self.scheduler = scheduler
        self.clip_each_step = clip_each_step
        self.default_inference_steps = default_inference_steps
        self.hf_class_name = hf_class_name
        # UNet compute precision for sampling; None keeps the UNet's own dtype
        self.compute_dtype = compute_dtype

    def save_pretrained(self, save_directory: str) -> None:
        os.makedirs(save_directory, exist_ok=True)
        index = {
            "_class_name": self.hf_class_name,
            "_diffusers_version": "0.16.0.dev0",
            "unet": ["diffusers", "UNet2DModel"],
            "scheduler": ["diffusers", self.scheduler.hf_class_name],
        }
        with open(os.path.join(save_directory, MODEL_INDEX_NAME), "w") as f:
            json.dump(index, f, indent=2, sort_keys=True)
        save_unet(self.unet, os.path.join(save_directory, "unet"))
        self.scheduler.save_config(os.path.join(save_directory, "scheduler"))

    @classmethod
    def from_pretrained(cls, path: str, device: DeviceLike = None, **kwargs) -> "DiffusionPipeline":
        """Load an HF-layout pipeline dir (as the JAX package or diffusers
        write it) onto ``device`` (CUDA by default)."""
        device = resolve_device(device)
        with open(os.path.join(path, MODEL_INDEX_NAME)) as f:
            index = json.load(f)
        unet = load_unet(path, subfolder="unet", device=device)
        scheduler = load_scheduler(path, subfolder="scheduler")
        return cls(unet, scheduler, hf_class_name=index.get("_class_name", "DDPMPipeline"), device=device, **kwargs)

    def sample_shape(self, batch_size: int) -> Tuple[int, int, int, int]:
        cfg = self.unet.config
        size = cfg.sample_size or 32
        return (batch_size, size, size, cfg.in_channels)

    def _compute_unet(self) -> UNet2DModel:
        if self.compute_dtype is None or self.compute_dtype == self.unet.dtype:
            return self.unet
        return self.unet.compute_copy(self.compute_dtype)

    @torch.inference_mode()
    def __call__(
        self,
        batch_size: int = 1,
        generator: Optional[torch.Generator] = None,
        init=None,
        num_inference_steps: Optional[int] = None,
        save_every_step: bool = False,
        capture_every: Optional[int] = None,
        start_from: int = 0,
        noise_source: Optional[NoiseSource] = None,
    ) -> PipelineOutput:
        """``init`` replaces the random initial latent (``noise + trigger``
        samples the backdoor); ``save_every_step`` captures the trajectory,
        strided by ``capture_every`` (about 50 frames by default). Random
        draws come from ``generator`` (default: one on the device seeded 0)."""
        n = num_inference_steps or self.default_inference_steps
        if save_every_step and capture_every is None:
            capture_every = max(1, n // 50)
        if not save_every_step:
            capture_every = None
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        if init is None:
            init = torch.randn(self.sample_shape(batch_size), generator=generator, device=self.device)
        else:
            init = torch.as_tensor(init, dtype=torch.float32, device=self.device)

        state = self.scheduler.set_timesteps(self.scheduler.create_state(), n)
        sample, movie = sample_loop(
            self.scheduler, state, self._compute_unet(), init,
            generator=generator, noise_source=noise_source, start_from=start_from,
            clip_each_step=self.clip_each_step, capture_every=capture_every,
        )
        images = to_images(sample).cpu().numpy()
        movie = None if movie is None else to_images(movie).cpu().numpy()
        return PipelineOutput(images=images, movie=movie)


def batchify(n: int, max_batch: int):
    """Split ``n`` into chunks of at most ``max_batch``."""
    replica, residual = divmod(n, max_batch)
    return [max_batch] * replica + ([residual] if residual else [])


def batch_sampling(
    sample_n: int,
    pipeline: DiffusionPipeline,
    init: Optional[np.ndarray] = None,
    max_batch_n: int = 256,
    generator: Optional[torch.Generator] = None,
    **kwargs,
) -> np.ndarray:
    """Sample in chunks of at most ``max_batch_n`` and concatenate. One
    generator serves every chunk in turn."""
    if generator is None:
        generator = torch.Generator(pipeline.device).manual_seed(0)
    sizes = batchify(sample_n if init is None else init.shape[0], max_batch_n)
    outs, ofs = [], 0
    for s in sizes:
        chunk = None if init is None else init[ofs : ofs + s]
        ofs += s
        outs.append(pipeline(batch_size=s, generator=generator, init=chunk, **kwargs).images)
    return np.concatenate(outs)
