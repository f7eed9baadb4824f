"""Checkpoint and resume: the trainer state in safetensors, and the
deployable HF pipeline (port of ``baddiffusion_tpu/training/checkpoint.py``).

Two formats side by side, as the reference writes them:

1. The trainer state, ``<out>/ckpt/state.safetensors``: every parameter
   (``params/<name>``), Adam's moments by parameter name (``mu/<name>``,
   ``nu/<name>``), Adam's ``count`` and ``TrainState.step``; with
   ``<out>/data.json`` = ``{"epoch", "step", "ckpt"}`` in the JAX package's
   schema, ``ckpt`` naming the directory that holds the state.
2. The HF layout (``DiffusionPipeline.save_pretrained(<out>)``), optionally
   also per epoch under ``<out>/epochs/ep{n}``.

The JAX package writes its trainer state with orbax, which the port cannot
read (nor can the JAX package read the port's): the HF export is the format
both packages load.

The train step updates the state in place, so a save copies every tensor to
the host before it returns; what the disk gets is the state of that step,
whatever runs next. The file is written by ``write_safetensors``: the
safetensors layout (an 8-byte header length, the JSON header, then each
tensor's bytes), each buffer handed to ``file.write`` as it lies in host
memory, so the interpreter lock is free while the bytes go to disk and a
training loop runs on beside an async write. With ``async_save`` that write
runs on a thread into a fresh ``<out>/ckpt.v{N}``, never over the live checkpoint, and
``data.json`` is written only once that write is known complete (at the next
save or at ``finish_async_saves()``); superseded directories are deleted
only after that. A crash inside the window leaves ``data.json`` naming the
previous complete checkpoint.

On several ranks every rank calls the save: a split layout's shards are
gathered first (``layout``, a ``parallel.ParallelLayout``), so the file on
disk is the one-rank file; rank 0 alone writes it, ``data.json`` and the HF
export, and a barrier ends each write. The async save stays one-rank only,
as the JAX package's does: on several ranks the save is synchronous. A
resume reads the one-rank file on every rank and keeps each rank's shards.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import struct
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, Optional, Tuple

import torch

from baddiffusion_tpu_torch.parallel.distributed import barrier, is_primary, world_size

CKPT_SUBDIR = "ckpt"
DATA_JSON = "data.json"
STATE_FILE = "state.safetensors"


def _write_atomic(path: str, write: Callable[[str], None]) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _write_data_json(out_dir: str, epoch: int, step: int, subdir: str = CKPT_SUBDIR) -> None:
    def write(tmp):
        with open(tmp, "w") as f:
            json.dump({"epoch": int(epoch), "step": int(step), "ckpt": subdir}, f)

    _write_atomic(os.path.join(out_dir, DATA_JSON), write)


def _ckpt_subdir(out_dir: str) -> str:
    """The checkpoint directory ``data.json`` names (``ckpt`` by default)."""
    try:
        with open(os.path.join(out_dir, DATA_JSON)) as f:
            return json.load(f).get("ckpt", CKPT_SUBDIR)
    except (OSError, ValueError):
        return CKPT_SUBDIR


def _next_version_subdir(out_dir: str) -> str:
    """A fresh ``ckpt.v{N}``, above every version on disk."""
    prefix = CKPT_SUBDIR + ".v"
    versions = [int(name[len(prefix):]) for name in os.listdir(out_dir)
                if name.startswith(prefix) and name[len(prefix):].isdigit()]
    return f"{prefix}{max(versions, default=-1) + 1}"


def _gc_stale_ckpts(out_dir: str, keep: str) -> None:
    """Delete the checkpoint directories other than ``keep``. Call only once
    ``data.json`` names ``keep`` and no write is in flight."""
    for name in os.listdir(out_dir):
        if name != keep and (name == CKPT_SUBDIR or name.startswith(CKPT_SUBDIR + ".v")):
            shutil.rmtree(os.path.join(out_dir, name), ignore_errors=True)


def _host_copy(state, layout=None) -> Dict[str, torch.Tensor]:
    """Every tensor of the state, whole, copied to contiguous host memory
    now (gathering a split layout's shards: a collective). From the card the
    copies land in pinned memory, all queued before one synchronise: this
    copy, not the write, is what an async save's caller waits for
    (``chip_smoke.py`` phase 6 times both, and the copy to pageable memory)."""
    copies = []

    def host(t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        if t.device.type != "cuda":
            return t.to("cpu", memory_format=torch.contiguous_format, copy=True)
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t, non_blocking=True)
        copies.append(t.device)
        return out

    names = list(state.params)
    whole = (lambda name, t: t) if layout is None or not layout.sharded else layout.unshard
    flat = {f"params/{k}": host(whole(k, p)) for k, p in state.params.items()}
    flat.update({f"mu/{k}": host(whole(k, m)) for k, m in zip(names, state.opt_state.mu)})
    flat.update({f"nu/{k}": host(whole(k, v)) for k, v in zip(names, state.opt_state.nu)})
    flat["count"] = torch.tensor(state.opt_state.count, dtype=torch.int64)
    flat["step"] = torch.tensor(state.step, dtype=torch.int64)
    for device in set(copies):
        torch.cuda.synchronize(device)
    return flat


# torch dtype -> the safetensors name of it
SAFETENSORS_DTYPES = {
    torch.float64: "F64", torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
    torch.int64: "I64", torch.int32: "I32", torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8",
    torch.bool: "BOOL",
}


def write_safetensors(path: str, flat: Dict[str, torch.Tensor]) -> None:
    """Write contiguous host tensors as a safetensors file that
    ``safetensors.torch.load_file`` reads back bitwise: the header's length
    (u64, little-endian), the JSON header (dtype, shape and byte offsets of
    each tensor, padded with spaces to 8 bytes), then the tensors' bytes in
    name order. Each tensor goes to ``file.write`` as a memoryview of its
    own buffer: no copy, and the write releases the interpreter lock."""
    names = sorted(flat)
    header, offset = {}, 0
    for name in names:
        t = flat[name]
        if t.device.type != "cpu" or not t.is_contiguous():
            raise ValueError(f"{name}: write_safetensors takes contiguous host tensors, got {t.device} "
                             f"strides {t.stride()}")
        size = t.numel() * t.element_size()
        header[name] = {"dtype": SAFETENSORS_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in names:
            f.write(memoryview(flat[name].reshape(-1).view(torch.uint8).numpy()))


def _write_state(path: str, flat: Dict[str, torch.Tensor]) -> None:
    os.makedirs(path, exist_ok=True)
    _write_atomic(os.path.join(path, STATE_FILE), lambda tmp: write_safetensors(tmp, flat))


class _AsyncWriter:
    """The process's one background checkpoint writer and the ``data.json``
    it still owes."""

    def __init__(self):
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: Optional[Tuple[Future, str, int, int, str]] = None  # (write, out_dir, epoch, step, subdir)

    def submit(self, out_dir: str, epoch: int, step: int, subdir: str, flat: Dict[str, torch.Tensor]) -> None:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
        write = self._pool.submit(_write_state, os.path.join(out_dir, subdir), flat)
        self._pending = (write, out_dir, epoch, step, subdir)

    def finish(self) -> None:
        """Wait for the write in flight; if it completed, publish its
        ``data.json`` and delete what it supersedes. A failed write raises
        here and leaves ``data.json`` as it was."""
        if self._pending is None:
            return
        write, out_dir, epoch, step, subdir = self._pending
        self._pending = None
        write.result()
        _write_data_json(out_dir, epoch, step, subdir)
        _gc_stale_ckpts(out_dir, keep=subdir)


_async_writer = _AsyncWriter()


def finish_async_saves() -> None:
    """Block until the async checkpoint in flight is on disk, then publish
    its ``data.json``. Call before reading a checkpoint back or exiting; a
    no-op when nothing is pending."""
    _async_writer.finish()


def save_trainer_state(out_dir: str, state, epoch: int, async_save: bool = False, layout=None
                       ) -> Dict[str, torch.Tensor]:
    """Write the trainer state and ``<out>/data.json``; see the module note.
    Every tensor is on the host when this returns, sync or async; returns
    those host copies, whole."""
    flat = _host_copy(state, layout)
    if world_size() > 1:  # every rank gathered; rank 0 writes
        try:
            if is_primary():
                _write_state(os.path.join(out_dir, CKPT_SUBDIR), flat)
                _write_data_json(out_dir, epoch, state.step)
                _gc_stale_ckpts(out_dir, keep=CKPT_SUBDIR)
        finally:  # a failed write on rank 0 must not leave its peers waiting
            barrier("ckpt_done")
        return flat
    os.makedirs(out_dir, exist_ok=True)
    # the previous async write done and its data.json published before this
    # save adds a version above it or supersedes it
    finish_async_saves()
    if async_save:
        _async_writer.submit(out_dir, epoch, state.step, _next_version_subdir(out_dir), flat)
        return flat
    _write_state(os.path.join(out_dir, CKPT_SUBDIR), flat)
    _write_data_json(out_dir, epoch, state.step)
    _gc_stale_ckpts(out_dir, keep=CKPT_SUBDIR)
    return flat


@torch.no_grad()
def load_trainer_state(out_dir: str, state_template, layout=None) -> Tuple[object, int, int]:
    """Restore the checkpoint into ``state_template`` in place (a
    ``TrainState`` of the same model and optimizer, on any device; with a
    ``layout``, this rank's shards of it, cut from the whole tensors) and
    return ``(state, start_epoch, start_step)``. ``start_epoch`` is the
    *saved* epoch, so a resumed ``train_loop`` runs that epoch again: the
    reference's resume does the same."""
    from safetensors.torch import load_file

    with open(os.path.join(out_dir, DATA_JSON)) as f:
        data = json.load(f)
    flat = load_file(os.path.join(out_dir, data.get("ckpt", CKPT_SUBDIR), STATE_FILE))
    state = state_template
    names = list(state.params)
    want = {f"{group}/{k}" for group in ("params", "mu", "nu") for k in names} | {"count", "step"}
    if set(flat) != want:
        raise ValueError(f"checkpoint in {out_dir} does not match the state: missing {sorted(want - set(flat))}, "
                         f"unexpected {sorted(set(flat) - want)}")
    targets = [(f"params/{k}", p) for k, p in state.params.items()]
    targets += [(f"mu/{k}", m) for k, m in zip(names, state.opt_state.mu)]
    targets += [(f"nu/{k}", v) for k, v in zip(names, state.opt_state.nu)]
    for key, t in targets:
        src = flat[key] if layout is None else layout.shard(key.partition("/")[2], flat[key])
        if src.shape != t.shape or src.dtype != t.dtype:
            raise ValueError(f"{key}: checkpoint has {tuple(src.shape)} {src.dtype}, "
                             f"the state {tuple(t.shape)} {t.dtype}")
        t.copy_(src)
    state.opt_state.count = int(flat["count"])
    state.step = int(flat["step"])
    return state, int(data["epoch"]), int(data["step"])


def save_checkpoint(
    out_dir: str,
    state,
    epoch: int,
    make_pipeline: Optional[Callable] = None,
    save_all_model_epochs: bool = False,
    async_save: bool = False,
    layout=None,
) -> None:
    """The reference's two formats: the trainer state, then the HF export of
    ``make_pipeline(state)`` (any object with ``save_pretrained``) to
    ``out_dir`` and, with ``save_all_model_epochs``, to
    ``ep_model_path(out_dir, epoch)``. The export is written before this
    returns, from the same step's parameters, even when the trainer state's
    write is async. On several ranks every rank calls it; ``make_pipeline``
    runs on rank 0 alone, given the state with whole parameters."""
    flat = save_trainer_state(out_dir, state, epoch, async_save=async_save, layout=layout)
    if make_pipeline is None:
        return
    if layout is not None and layout.sharded:
        state = dataclasses.replace(state, params={k: flat[f"params/{k}"] for k in state.params})
    try:
        if is_primary():
            pipe = make_pipeline(state)
            pipe.save_pretrained(out_dir)
            if save_all_model_epochs:
                pipe.save_pretrained(ep_model_path(out_dir, epoch))
    finally:  # a failed export on rank 0 must not leave its peers waiting
        barrier("hf_export")


def has_trainer_state(out_dir: str) -> bool:
    return os.path.exists(os.path.join(out_dir, DATA_JSON)) and os.path.isdir(
        os.path.join(out_dir, _ckpt_subdir(out_dir))
    )


def ep_model_path(out_dir: str, epoch: int) -> str:
    """The per-epoch snapshot directory, ``<out>/epochs/ep{epoch}``."""
    return os.path.join(out_dir, "epochs", f"ep{epoch}")
