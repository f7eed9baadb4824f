"""The device mesh and the batch's layout over it (port of
``baddiffusion_tpu/parallel/mesh.py``).

A ``torch.distributed.device_mesh.DeviceMesh`` over the ranks, laid out as
the JAX package's CLI lays its mesh: the ``data`` axis of N/m ranks and, with
``model_parallel`` m above 1, the ``model`` axis of m ranks (rank = data
index · m + model index). The data axis splits each micro-batch's rows; the
model axis splits the widest layers' output channels
(``parallel.sharding_rules``).

No counterpart: ``put_global`` and ``replicated``. There is no host value to
place without a rendezvous: each rank holds its own copy of every replicated
value and slices its own rows and shards from it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from baddiffusion_tpu_torch.parallel.distributed import take_rows, world_size

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(device: Union[str, torch.device], model_parallel: int = 1) -> DeviceMesh:
    """The mesh over every rank of the process group: ``(data,)``, or
    ``(data, model)`` with ``model_parallel`` above 1. Every rank calls it,
    in the same order as its other collectives."""
    n = world_size()
    m = max(1, model_parallel)
    if n % m:
        raise ValueError(f"--model_parallel {m} does not divide {n} ranks")
    device_type = torch.device(device).type
    if m > 1:
        return init_device_mesh(device_type, (n // m, m), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return init_device_mesh(device_type, (n,), mesh_dim_names=(DATA_AXIS,))


def axis(mesh: Optional[DeviceMesh], name: str) -> Tuple[Optional[object], int, int]:
    """``(process group, size, this rank's index)`` of one axis; a mesh
    without the axis (or no mesh) has it at size 1, index 0, no group."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None, 1, 0
    return mesh.get_group(name), mesh.size(mesh.mesh_dim_names.index(name)), mesh.get_local_rank(name)


@dataclasses.dataclass(frozen=True)
class RowSharding:
    """A rank's rows of each global batch over the data axis: ``grad_accum``
    micro-batches, each split evenly over ``count`` ranks
    (``distributed.row_index``). Called on a dict of arrays (or one array or
    tensor), it returns the rank's rows."""

    group: Optional[object]
    index: int
    count: int
    grad_accum: int = 1

    def __call__(self, batch):
        if isinstance(batch, dict):
            return {k: take_rows(v, self.index, self.count, self.grad_accum) for k, v in batch.items()}
        return take_rows(batch, self.index, self.count, self.grad_accum)


def batch_sharding(mesh: Optional[DeviceMesh], grad_accum: int = 1) -> RowSharding:
    """The batch's layout: its rows split over the data axis (the model axis
    replicates them)."""
    group, size, index = axis(mesh, DATA_AXIS)
    return RowSharding(group, index, size, grad_accum)


def shard_batch(batch: Dict[str, object], mesh: Optional[DeviceMesh], grad_accum: int = 1) -> Dict[str, object]:
    """This rank's rows of a global batch dict."""
    return batch_sharding(mesh, grad_accum)(batch)
