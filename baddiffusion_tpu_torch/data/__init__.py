from baddiffusion_tpu_torch.data.poison import poison_batch, poison_batch_host
from baddiffusion_tpu_torch.data.triggers import ASSETS_DIR, Backdoor, trigger_mask

__all__ = ["ASSETS_DIR", "Backdoor", "poison_batch", "poison_batch_host", "trigger_mask"]
