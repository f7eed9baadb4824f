from baddiffusion_tpu_torch.io.hf import (
    SAFETENSORS_NAME,
    WEIGHTS_NAME,
    load_torch_state_dict,
    load_unet,
    perturb_from_jax,
    save_unet,
    state_dict_from_jax,
)

__all__ = [
    "SAFETENSORS_NAME",
    "WEIGHTS_NAME",
    "load_torch_state_dict",
    "load_unet",
    "perturb_from_jax",
    "save_unet",
    "state_dict_from_jax",
]
