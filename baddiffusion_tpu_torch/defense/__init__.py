from baddiffusion_tpu_torch.defense.anp import (
    ANPStep,
    apply_perturb,
    clip_perturb,
    init_perturb,
    make_anp_step,
    perturb_leaves,
    perturbed_copy,
    perturbed_forward,
)

__all__ = [
    "ANPStep",
    "apply_perturb",
    "clip_perturb",
    "init_perturb",
    "make_anp_step",
    "perturb_leaves",
    "perturbed_copy",
    "perturbed_forward",
]
