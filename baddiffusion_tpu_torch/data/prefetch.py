"""Host → device prefetch (port of ``baddiffusion_tpu/data/prefetch.py``).

A background thread stages the next batches on the device while the current
step runs. On CUDA each array is pinned, then copied with ``non_blocking`` on
a side stream; the batch carries an event recorded after its copies, and the
consumer's stream waits on that event before anything reads the batch (the
per-batch form of ``wait_stream``). Each tensor is marked as used on the
consumer's stream (``record_stream``), so the caching allocator does not hand
its memory to a later copy while the consumer's kernels may still read it.
On a CPU device the thread only wraps the arrays as tensors.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from baddiffusion_tpu_torch.device import DeviceLike, resolve_device

_SENTINEL = object()


def device_prefetch(
    batches: Iterator[Dict[str, np.ndarray]], device: DeviceLike = None, size: int = 2
) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield ``batches`` as dicts of tensors on ``device`` (CUDA unless the
    caller asks otherwise; raises without a GPU), keeping ``size`` staged
    ahead. An exception in the source iterator is raised here, in the
    consumer. Closing the generator early stops the thread."""
    device = resolve_device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()

    def stage(batch):
        if stream is None:
            return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}, None
        with torch.cuda.stream(stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(device, non_blocking=True)
                   for k, v in batch.items()}
            ready = torch.cuda.Event()
            ready.record(stream)
        return out, ready

    def worker():
        try:
            for batch in batches:
                if stop.is_set():
                    return
                q.put(stage(batch))
        except Exception as exc:  # raised again in the consumer
            q.put(exc)
        q.put(_SENTINEL)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, Exception):
                raise item
            out, ready = item
            if ready is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)
                for t in out.values():
                    t.record_stream(consumer)
            yield out
    finally:
        stop.set()
        while thread.is_alive():  # unblock a worker waiting on a full queue
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass
        thread.join()
