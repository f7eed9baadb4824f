"""Host → device prefetch (port of ``baddiffusion_tpu/data/prefetch.py``).

A background thread stages the next batches on the device while the current
step runs. On CUDA each array is pinned, then copied with ``non_blocking`` on
a side stream; the batch carries an event recorded after its copies, and the
consumer's stream waits on that event before anything reads the batch (the
per-batch form of ``wait_stream``). Each tensor is marked as used on the
consumer's stream (``record_stream``), so the caching allocator does not hand
its memory to a later copy while the consumer's kernels may still read it.
On a CPU device the thread only wraps the arrays as tensors. With ``rows``
(``parallel.batch_sharding``), each rank stages only its rows of each
global batch, as the JAX loop feeds each process's rows.

Under a recording profiler the consumer's wait for a batch (the queue and
the event) is the span ``data.wait`` and the thread's staging of one
``data.stage`` (``utils/profiling.span``); the thread's span lands in the
trace only when the profiler records every thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from baddiffusion_tpu_torch.device import DeviceLike, resolve_device
from baddiffusion_tpu_torch.utils.profiling import span

_SENTINEL = object()


def device_prefetch(
    batches: Iterator[Dict[str, np.ndarray]], device: DeviceLike = None, size: int = 2,
    rows: Optional[Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]] = None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield ``batches`` as dicts of tensors on ``device`` (CUDA unless the
    caller asks otherwise; raises without a GPU), keeping ``size`` staged
    ahead; ``rows(batch)`` first keeps this rank's rows. An exception in the
    source iterator is raised here, in the consumer. Closing the generator
    early stops the thread."""
    device = resolve_device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()

    def stage(batch):
        if rows is not None:
            batch = rows(batch)
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
                with span("data.stage"):
                    staged = stage(batch)
                q.put(staged)
        except Exception as exc:  # raised again in the consumer
            q.put(exc)
        q.put(_SENTINEL)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            with span("data.wait"):
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
