"""Scale-out over ranks (port of ``baddiffusion_tpu/parallel/``): one
process a device, joined through ``torch.distributed``."""

from baddiffusion_tpu_torch.parallel.distributed import (
    barrier,
    host_shard_slice,
    initialize,
    is_primary,
    local_rows,
    rank,
    shutdown,
    world_size,
)
from baddiffusion_tpu_torch.parallel.layout import ParallelLayout, place_train_state
from baddiffusion_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, batch_sharding, make_mesh, shard_batch
from baddiffusion_tpu_torch.parallel.sharding_rules import fsdp_param_specs, train_state_specs, unet_param_specs

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "ParallelLayout",
    "barrier",
    "batch_sharding",
    "fsdp_param_specs",
    "host_shard_slice",
    "initialize",
    "is_primary",
    "local_rows",
    "make_mesh",
    "place_train_state",
    "rank",
    "shard_batch",
    "shutdown",
    "train_state_specs",
    "unet_param_specs",
    "world_size",
]
