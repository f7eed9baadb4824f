"""Processes and ranks (port of ``baddiffusion_tpu/parallel/distributed.py``).

One process drives one device, PyTorch's idiom: ``torchrun --nproc_per_node
N`` starts N processes, and rank r takes the r-th card of ``--gpu`` (or
``cuda:LOCAL_RANK``). The JAX package runs one process a host instead,
driving every chip of the host through one mesh.

``initialize`` joins the process group from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``), or from a store
the caller hands in (the tests use a ``FileStore``: no TCP port). The backend
follows a rule, never a failure: NCCL when every rank has a CUDA device of
its own, gloo on the CPU or when ranks share a card. ``barrier`` waits on the
process group's store, with a timeout, and needs no collective.

No counterpart: ``warmup_collectives``, ``warmup_mesh_collectives``,
``compile_aligned`` and ``AlignedStep``. They bound the skew between
processes that XLA's compiles cause at a program's first run, before the
first collective. An eager step compiles nothing, so their counterpart is
one ``barrier`` before a rank's first step (``training.trainer.train_loop``,
``anp_cli``).
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0


class _Group:
    """The store this process joined its group through, and how many keys
    (barriers, handshakes) it has used there: every rank uses them in the
    same order, so the count names each one alike on every rank."""

    store: Optional[dist.Store] = None
    keys: int = 0


_group = _Group()


def backend_for(device: torch.device, shares_card: bool) -> str:
    """NCCL when every rank has a CUDA device of its own; gloo on the CPU,
    or when two ranks share one card (NCCL refuses two ranks on one card)."""
    return "nccl" if device.type == "cuda" and not shares_card else "gloo"


def initialize(
    device: Union[str, torch.device],
    shares_card: bool = False,
    store: Optional[dist.Store] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> str:
    """Join the process group on ``device`` and return the backend. Without
    ``store``, torchrun's environment gives the store, the rank and the world
    size. A rank whose peers do not all arrive raises within ``timeout_s``
    (the same bound holds for every collective after)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if store is None:
        store, rank, world_size = next(dist.rendezvous("env://", timeout=datetime.timedelta(seconds=timeout_s)))
    if rank is None or world_size is None:
        raise ValueError("a store needs its rank and world size")
    backend = backend_for(device, shares_card)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            device_id=device if backend == "nccl" else None)
    _group.store = store
    _group.keys = 0
    return backend


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _group.store = None
    _group.keys = 0


def launched_ranks() -> int:
    """The ranks this process was launched among: the process group's size,
    else torchrun's ``WORLD_SIZE`` (1 without it)."""
    return dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", "1"))


def world_size() -> int:
    """The number of ranks: the process group's, or 1 outside one. A process
    that torchrun started (``WORLD_SIZE`` above 1) but that has not joined
    its group raises: it would otherwise train alone on the whole batch."""
    if dist.is_initialized():
        return dist.get_world_size()
    env = int(os.environ.get("WORLD_SIZE", "1"))
    if env > 1:
        raise RuntimeError(f"WORLD_SIZE is {env} but this process has not joined its process group: call "
                           "baddiffusion_tpu_torch.parallel.initialize() first (cli.main and anp_cli.main do)")
    return 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    """This process's index among the ranks of its host (torchrun's
    ``LOCAL_RANK``; a group joined through a store is taken as one host)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def is_primary() -> bool:
    return rank() == 0


def store() -> dist.Store:
    if _group.store is None:
        raise RuntimeError("no process group was joined through parallel.initialize()")
    return _group.store


def next_key(tag: str) -> str:
    """A fresh store key for ``tag``, the same on every rank that uses its
    keys in the same order."""
    _group.keys += 1
    return f"baddiffusion:{_group.keys}:{tag}"


def barrier(tag: str, timeout_s: float = 600.0) -> None:
    """Wait until every rank has reached this barrier, or raise
    ``TimeoutError`` after ``timeout_s``. Every rank calls the barriers in the
    same order. It runs on the store, so it takes no collective context and
    tolerates any skew within the timeout."""
    if world_size() <= 1:
        return
    key = next_key(f"barrier:{tag}")
    kv = store()
    arrived = kv.add(key, 1)
    if arrived == world_size():
        kv.set(key + ":all", "1")
    try:
        kv.wait([key + ":all"], datetime.timedelta(seconds=timeout_s))
    except RuntimeError as exc:  # the store's wait timed out
        raise TimeoutError(f"rank {rank()}: barrier {tag!r} timed out after {timeout_s} s "
                           f"({kv.add(key, 0)} of {world_size()} ranks arrived)") from exc


def signal(key: str, value: str) -> None:
    """Set ``key`` (from ``next_key``) in the group's store: a message to
    peers, scoped to this launch (the store lives as long as the launch)."""
    store().set(key, value)


def wait_for(key: str, timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """The value of ``key`` once a peer has set it, or ``TimeoutError``."""
    kv = store()
    try:
        kv.wait([key], datetime.timedelta(seconds=timeout_s))
    except RuntimeError as exc:
        raise TimeoutError(f"rank {rank()}: no peer set {key!r} within {timeout_s} s") from exc
    return kv.get(key).decode()


def host_shard_slice(total: int, process_index: Optional[int] = None, process_count: Optional[int] = None) -> slice:
    """This rank's contiguous slice of a globally sized batch or dataset."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    per = total // pc
    return slice(pi * per, (pi + 1) * per)


def row_index(total: int, index: int, count: int, grad_accum: int = 1) -> np.ndarray:
    """The rows a rank of ``count`` keeps of a global batch of ``total`` rows
    that splits into ``grad_accum`` micro-batches: rows ``[index·m/count,
    (index+1)·m/count)`` of each micro-batch of m rows. Every rank's
    micro-batches are then equal, so the means over a rank's rows, averaged
    over the ranks, are the global means."""
    if total % grad_accum or (total // grad_accum) % count:
        raise ValueError(f"a batch of {total} rows in {grad_accum} micro-batches does not split over {count} ranks")
    micro = total // grad_accum
    per = micro // count
    return (np.arange(grad_accum)[:, None] * micro + index * per + np.arange(per)[None, :]).reshape(-1)


def take_rows(x, index: int, count: int, grad_accum: int = 1):
    """``x``'s rows for a rank (``row_index``): a slice when the rows are
    contiguous, else a gather. ``x`` is a numpy array or a tensor."""
    if count == 1:
        return x
    idx = row_index(x.shape[0], index, count, grad_accum)
    if grad_accum == 1:
        return x[int(idx[0]):int(idx[-1]) + 1]
    return x[torch.from_numpy(idx).to(x.device)] if torch.is_tensor(x) else x[idx]


def local_rows(batch: Dict[str, np.ndarray], index: Optional[int] = None, count: Optional[int] = None,
               grad_accum: int = 1) -> Dict[str, np.ndarray]:
    """The counterpart of ``global_batch_from_host_shards``: every rank loads
    the global batch and keeps its own rows (``row_index``) of each array."""
    index = rank() if index is None else index
    count = world_size() if count is None else count
    return {k: take_rows(v, index, count, grad_accum) for k, v in batch.items()}
