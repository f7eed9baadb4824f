"""Device ms an optimizer step in the kernels launched while one of the
program's ``train.backward`` spans was open (each micro-batch's
``loss.backward()``).

The autograd engine launches the backward's kernels from its own thread, not
from the thread that holds the span, so a kernel is matched by the time of
its launch (correlation id → the launch call's timestamp), on any thread but
two kinds: a thread that ran a ``data.stage`` span (the feed's pinned
copies), and a thread on which the trace holds no host op at all (one the
profiler did not follow: the feed's, under a profiler that records only the
thread that started it and its autograd workers)."""

import bisect

from bench_port.trace import _union

LAYER = "train step"
MOVES = "train_samples_per_s"


def backward_seconds(tl) -> float:
    spans = _union([(s, t) for s, t, name, _, cat in tl.host if name == "train.backward" and cat == "user_annotation"])
    if not spans:
        return 0.0
    starts = [s for s, _ in spans]
    followed = {tid for _, _, _, tid, _ in tl.host}
    feed = {tid for _, _, name, tid, _ in tl.host if name == "data.stage"}
    total = 0.0
    for s, t, _, corr in tl.device:
        launch = tl.launch.get(corr)
        if launch is None or launch[1] in feed or launch[1] not in followed:
            continue
        i = bisect.bisect_right(starts, launch[0]) - 1
        if i >= 0 and spans[i][1] >= launch[0]:
            total += t - s
    return total / 1e6


def read(ctx):
    if ctx.mode != "train":
        return None
    seconds = backward_seconds(ctx.timeline)
    return 1e3 * seconds / ctx.steps if seconds > 0 else None
