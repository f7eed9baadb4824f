from baddiffusion_tpu_torch.utils.image import make_grid, normalize, path_gen, save_image_grid
from baddiffusion_tpu_torch.utils.logging import Log, MemoryLog
from baddiffusion_tpu_torch.utils.samples import Samples
from baddiffusion_tpu_torch.utils.trackers import Tracker

__all__ = ["Log", "MemoryLog", "normalize", "make_grid", "save_image_grid", "path_gen", "Samples", "Tracker"]
