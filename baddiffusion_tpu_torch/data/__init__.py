from baddiffusion_tpu_torch.data.triggers import ASSETS_DIR, Backdoor, trigger_mask

__all__ = ["ASSETS_DIR", "Backdoor", "trigger_mask"]
