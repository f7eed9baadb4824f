"""HF-layout UNet and VQ-VAE checkpoints, and weights carried over from the
JAX package (port of ``baddiffusion_tpu/io/hf.py``).

``state_dict_from_jax`` is the port's own copy of the conversion rules from
the JAX package's nested param dict (numpy arrays, NHWC/HWIO layout) to the
HF-0.16 torch state dict that ``UNet2DModel`` and ``VQModel`` load with
``strict=True``:

  - pytree path ``down_blocks_0/resnets_1`` → module path ``down_blocks.0.resnets.1``
    (only for the ModuleList containers; ``linear_1`` keeps its underscore)
  - conv ``kernel`` [H,W,I,O] → ``weight`` [O,I,H,W]
  - dense ``kernel`` [I,O] → ``weight`` [O,I]
  - norm ``scale`` → ``weight``; ``embedding`` → ``weight`` (the class
    embedding, the VQ codebook ``quantize.embedding``)

``perturb_from_jax`` carries an ANP perturbation (``defense/anp.py``) across
by the same path rule: the JAX tree ``{conv path: {gamma, beta}}`` becomes
``{state-dict module name: {"gamma", "beta"}}``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from baddiffusion_tpu_torch.device import DeviceLike
from baddiffusion_tpu_torch.models.unet2d import UNet2DConfig, UNet2DModel
from baddiffusion_tpu_torch.models.vae import VQModel, VQModelConfig

WEIGHTS_NAME = "diffusion_pytorch_model.bin"
SAFETENSORS_NAME = "diffusion_pytorch_model.safetensors"

# ModuleList containers whose merged indices are split again ('down_blocks_0' -> 'down_blocks.0')
_CONTAINERS = {"down_blocks", "up_blocks", "resnets", "attentions", "downsamplers", "upsamplers"}


def _module_name(name: str) -> str:
    """One pytree path element as a module path element."""
    base, _, index = name.rpartition("_")
    return f"{base}.{index}" if index.isdigit() and base in _CONTAINERS else name


def state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested JAX/flax params (numpy arrays) → flat HF torch state dict."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for name, value in node.items():
            if isinstance(value, dict):
                walk(value, prefix + [_module_name(name)])
                continue
            value = np.asarray(value)
            leaf = name
            if leaf == "kernel":
                leaf = "weight"
                value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.transpose(1, 0)
            elif leaf in ("scale", "embedding"):
                leaf = "weight"
            out[".".join(prefix + [leaf])] = torch.from_numpy(value.copy())  # contiguous and writable

    walk(params, [])
    return out


def perturb_from_jax(perturb: Dict[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX ANP perturbation tree (numpy arrays) → ``{conv module name:
    {"gamma": [O], "beta": [O]}}`` (``beta`` only where the JAX tree has
    it), in the port's ``defense.anp`` layout."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}

    def walk(node, prefix):
        leaves = {k: v for k, v in node.items() if not isinstance(v, dict)}
        if leaves:
            out[".".join(prefix)] = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in leaves.items()}
        for name, value in node.items():
            if isinstance(value, dict):
                walk(value, prefix + [_module_name(name)])

    walk(perturb, [])
    return out


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read an HF model dir (or a .safetensors/.bin file) into CPU tensors."""
    if os.path.isdir(path):
        for name in (SAFETENSORS_NAME, WEIGHTS_NAME):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(f"no {SAFETENSORS_NAME} or {WEIGHTS_NAME} under {path}")
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def save_unet(unet, save_directory: str, use_safetensors: bool = True) -> None:
    """Write config.json + f32 weights, readable by the JAX package and
    diffusers: a ``UNet2DModel`` or a ``VQModel``."""
    os.makedirs(save_directory, exist_ok=True)
    unet.config.save(save_directory)
    sd = {k: v.detach().to("cpu", torch.float32).contiguous() for k, v in unet.state_dict().items()}
    if use_safetensors:
        from safetensors.torch import save_file

        save_file(sd, os.path.join(save_directory, SAFETENSORS_NAME))
    else:
        torch.save(sd, os.path.join(save_directory, WEIGHTS_NAME))


def load_unet(path: str, subfolder: Optional[str] = None, device: DeviceLike = None,
              dtype: torch.dtype = torch.float32) -> UNet2DModel:
    """Load an HF-layout UNet2DModel dir onto ``device`` (CUDA by default),
    computing in ``dtype`` (its parameters stay f32)."""
    if subfolder:
        path = os.path.join(path, subfolder)
    model = UNet2DModel(UNet2DConfig.load(path), device=device, dtype=dtype)
    model.load_state_dict(load_torch_state_dict(path), strict=True)
    return model


def load_vqmodel(path: str, subfolder: Optional[str] = None, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32) -> VQModel:
    """Load an HF-layout VQModel dir onto ``device`` (CUDA by default),
    computing in ``dtype`` (its parameters stay f32)."""
    if subfolder:
        path = os.path.join(path, subfolder)
    model = VQModel(VQModelConfig.load(path), device=device, dtype=dtype)
    model.load_state_dict(load_torch_state_dict(path), strict=True)
    return model
