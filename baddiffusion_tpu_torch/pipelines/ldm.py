"""Unconditional latent diffusion: VQ-VAE latents, a UNet and a scheduler
(port of ``baddiffusion_tpu/pipelines/ldm.py``).

``LDMPipeline`` serves wherever ``DiffusionPipeline`` does
(``batch_sampling_save``, ``cli.run_measure``, ``trainer.sample_grids``):
``sample_shape`` is in pixel space, and a pixel-shaped ``init`` (noise +
trigger from the measure and the grids) is VQ-encoded to latents before
the chain; a latent-shaped ``init`` is taken as it is, and without one the
chain starts from latent noise. The chain is ``sample_loop`` with a clamp to ±1 after
every step when ``clip_sample``; the result (and each movie frame) is
VQ-decoded. The UNet computes in ``compute_dtype`` (a copy of its weights
cast once a call), the VQ-VAE in its own dtype; the scheduler's arithmetic
stays f32. ``save_pretrained``/``from_pretrained`` use the HF layout:
``model_index.json`` (``_class_name: LDMPipeline``), ``vqvae/``, ``unet/``,
``scheduler/``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from baddiffusion_tpu_torch.device import DeviceLike, resolve_device
from baddiffusion_tpu_torch.io import load_unet, load_vqmodel, save_unet
from baddiffusion_tpu_torch.models.unet2d import UNet2DModel
from baddiffusion_tpu_torch.models.vae import VQModel
from baddiffusion_tpu_torch.pipelines.pipeline import MODEL_INDEX_NAME, PipelineOutput
from baddiffusion_tpu_torch.pipelines.sampler import NoiseSource, sample_loop, to_images
from baddiffusion_tpu_torch.schedulers import load_scheduler

LDM_CLASS_NAME = "LDMPipeline"


class LDMPipeline:
    """A (vqvae, unet, scheduler) bundle on ``device`` (CUDA unless the
    caller asks otherwise; raises without a GPU)."""

    def __init__(
        self,
        vqvae: VQModel,
        unet: UNet2DModel,
        scheduler,
        clip_sample: bool = False,
        compute_dtype: Optional[torch.dtype] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.vqvae = vqvae.to(self.device).eval()
        self.unet = unet.to(self.device).eval()
        self.scheduler = scheduler
        self.clip_sample = clip_sample
        self.default_inference_steps = 50
        self.hf_class_name = LDM_CLASS_NAME
        # UNet compute precision for sampling; None keeps the UNet's own dtype
        self.compute_dtype = compute_dtype

    # -- latent helpers -----------------------------------------------------
    @torch.inference_mode()
    def encode(self, image: torch.Tensor, scaling_factor: Optional[float] = None) -> torch.Tensor:
        """Pixel NHWC images → f32 latents (× ``scaling_factor`` if given)."""
        latents = self.vqvae.encode(torch.as_tensor(image, device=self.device)).float()
        return latents * scaling_factor if scaling_factor is not None else latents

    @torch.inference_mode()
    def decode(self, latents: torch.Tensor, scaling_factor: Optional[float] = None) -> torch.Tensor:
        """Latents → f32 images in model space. Kept from the reference:
        ``scaling_factor`` divides the decoded *image*, not the latents, so
        ``decode(encode(x, sf), sf)`` does not invert; no caller passes it."""
        image = self.vqvae.decode(torch.as_tensor(latents, device=self.device)).float()
        return image / scaling_factor if scaling_factor is not None else image

    def sample_shape(self, batch_size: int):
        """The pixel-space init shape, where the measure and the grids stamp
        the trigger."""
        cfg = self.vqvae.config
        return (batch_size, cfg.sample_size, cfg.sample_size, cfg.in_channels)

    def latent_shape(self, batch_size: int):
        cfg = self.unet.config
        return (batch_size, cfg.sample_size, cfg.sample_size, cfg.in_channels)

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
        noise_source: Optional[NoiseSource] = None,
        output_type: str = "np",
    ) -> PipelineOutput:
        """As ``DiffusionPipeline.__call__`` (without ``start_from``);
        ``save_every_step`` captures
        about 10 frames by default, each decoded. With ``output_type="pt"``,
        ``sample`` is the decoded image before the mapping to [0, 1]."""
        n = num_inference_steps or self.default_inference_steps
        if save_every_step and capture_every is None:
            capture_every = max(1, n // 10)
        if not save_every_step:
            capture_every = None
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        if init is None:
            init = torch.randn(self.latent_shape(batch_size), generator=generator, device=self.device)
        else:
            init = torch.as_tensor(init, dtype=torch.float32, device=self.device)
            vq_size = self.vqvae.config.sample_size
            if init.shape[1] == vq_size and vq_size != self.unet.config.sample_size:
                init = self.encode(init)

        state = self.scheduler.set_timesteps(self.scheduler.create_state(), n)
        latents, movie = sample_loop(
            self.scheduler, state, self._compute_unet(), init, generator=generator, noise_source=noise_source,
            clip_each_step=1.0 if self.clip_sample else None, capture_every=capture_every,
        )
        image = self.decode(latents)
        images = to_images(image)
        if movie is not None:  # one decode a frame: a frame is a sampling batch
            movie = torch.stack([to_images(self.decode(frame)) for frame in movie])
        if output_type == "pt":
            return PipelineOutput(images=images, movie=movie, sample=image)
        return PipelineOutput(images=images.cpu().numpy(), movie=None if movie is None else movie.cpu().numpy())

    # -- serialization --------------------------------------------------------
    def save_pretrained(self, save_directory: str) -> None:
        os.makedirs(save_directory, exist_ok=True)
        index = {
            "_class_name": LDM_CLASS_NAME,
            "_diffusers_version": "0.16.0.dev0",
            "unet": ["diffusers", "UNet2DModel"],
            "vqvae": ["diffusers", "VQModel"],
            "scheduler": ["diffusers", self.scheduler.hf_class_name],
        }
        with open(os.path.join(save_directory, MODEL_INDEX_NAME), "w") as f:
            json.dump(index, f, indent=2, sort_keys=True)
        save_unet(self.unet, os.path.join(save_directory, "unet"))
        save_unet(self.vqvae, os.path.join(save_directory, "vqvae"))
        self.scheduler.save_config(os.path.join(save_directory, "scheduler"))

    @classmethod
    def from_pretrained(cls, path: str, clip_sample: bool = False, dtype: torch.dtype = torch.float32,
                        device: DeviceLike = None, **kwargs) -> "LDMPipeline":
        """Load an HF-layout LDM dir (as the JAX package or diffusers write
        it) onto ``device`` (CUDA by default); the UNet and the VQ-VAE compute
        in ``dtype``."""
        device = resolve_device(device)
        unet = load_unet(path, subfolder="unet", device=device, dtype=dtype)
        vqvae = load_vqmodel(path, subfolder="vqvae", device=device, dtype=dtype)
        scheduler = load_scheduler(path, subfolder="scheduler")
        return cls(vqvae, unet, scheduler, clip_sample=clip_sample, device=device, **kwargs)


def is_ldm_dir(path: str) -> bool:
    """Whether ``path`` holds an LDM pipeline (its ``model_index.json`` names
    LDMPipeline or a ``vqvae``)."""
    index_path = os.path.join(path, MODEL_INDEX_NAME)
    if not os.path.exists(index_path):
        return False
    with open(index_path) as f:
        index = json.load(f)
    return index.get("_class_name") == LDM_CLASS_NAME or "vqvae" in index
