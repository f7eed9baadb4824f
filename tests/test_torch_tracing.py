"""The port's spans and set-up counter (``utils/profiling.py``), where the
program opens them, and the benchmark's readers of them (on the CPU, a few
seconds): no span costs a ``record_function`` or an allocation while no
profiler records; under the CPU profiler the train step, the optimizer, the
feed, the chain and the UNet write their spans, nested as they run; each
reader gives its number on a small made-up trace."""

import json
import os
import threading
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from baddiffusion_tpu_torch.data.prefetch import device_prefetch
from baddiffusion_tpu_torch.models import UNet2DConfig, UNet2DModel
from baddiffusion_tpu_torch.pipelines import DiffusionPipeline
from baddiffusion_tpu_torch.schedulers import DDPMConfig, DDPMScheduler
from baddiffusion_tpu_torch.training import create_train_state, make_optimizer, make_train_step
from baddiffusion_tpu_torch.utils import profiling
from bench_port import harness
from bench_port.common import TraceContext
from bench_port.trace import Timeline
from bench_port.work.model import sites

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = UNet2DConfig(sample_size=8, layers_per_block=1, block_out_channels=(8, 16), norm_num_groups=4,
                    down_block_types=("DownBlock2D", "AttnDownBlock2D"),
                    up_block_types=("AttnUpBlock2D", "UpBlock2D"), attention_head_dim=None)
BLOCKS = ["unet.embed", "unet.down.0", "unet.down.1", "unet.mid", "unet.up.0", "unet.up.1", "unet.out"]


def _spans(prof, tmp_path):
    """The trace's spans as (name, start, end, thread), in start order."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("tid")) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return sorted(spans, key=lambda s: s[1])


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


# ---------------------------------------------------------------- the mechanism


def test_spans_cost_nothing_without_a_profiler(monkeypatch):
    """No profiler: no ``record_function`` entered, one shared no-op object,
    and nothing allocated over 10,000 spans."""
    def forbidden(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("train.step") is profiling.span("unet.forward")
    span = profiling.span
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in range(10_000):
            with span("sampler.step"):
                pass
        after = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert after - before < 1024  # nothing a span (a handful of bytes of tracemalloc's own, at most)


def test_spans_record_under_a_profiler(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(4).sum()
    spans = _spans(prof, tmp_path)
    assert [s[0] for s in spans] == ["outer", "inner"] and _inside(spans[1], spans[0])
    assert profiling.span("outer") is profiling.span("inner")  # the no-op again once the profiler stopped


def test_timed_counts_with_or_without_a_profiler(tmp_path):
    profiling.reset_counters()
    with profiling.timed("phase"):
        torch.ones(8).sum()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.timed("phase"):
            torch.ones(8).sum()
    with pytest.raises(RuntimeError, match="boom"):
        with profiling.timed("phase"):
            raise RuntimeError("boom")
    calls, seconds = profiling.counters()["phase"]
    assert calls == 3 and seconds > 0
    assert [s[0] for s in _spans(prof, tmp_path)] == ["phase"]
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_unet_construction_counts_one_init():
    profiling.reset_counters()
    UNet2DModel(TINY, device="cpu")
    calls, seconds = profiling.counters()["unet.init"]
    assert calls == 1 and seconds > 0
    model = UNet2DModel(TINY, device="cpu")
    model.compute_copy(torch.bfloat16)  # a copy is no construction
    assert profiling.counters()["unet.init"][0] == 2


def test_union_counts_overlap_once():
    assert profiling._union_ms([(5.0, 7.0), (0.0, 2.0), (1.0, 3.0), (6.0, 6.5), (9.0, 9.0)]) == pytest.approx(5.0)
    assert profiling._union_ms([]) == 0.0


# ---------------------------------------------------------------- where the program opens them


def test_train_step_spans(tmp_path):
    """A step of two micro-batches: one ``train.step`` holding two
    ``train.forward``, two ``train.backward`` and one ``optim.update``, in
    that order; each forward holds a UNet forward."""
    model = UNet2DModel(TINY, device="cpu", generator=torch.Generator().manual_seed(0))
    opt, _ = make_optimizer(1e-3, num_warmup_steps=0, num_training_steps=10)
    hw = (8, 8, 3)
    state = create_train_state(model, opt, np.zeros(hw, np.float32), np.zeros(hw, np.float32), np.zeros(hw, np.float32))
    sched = DDPMScheduler(DDPMConfig()).create_state().schedule
    step = make_train_step(model, opt, 1000, sched.alphas, sched.alphas_cumprod, grad_accum=2, device="cpu")
    image = torch.randint(0, 256, (4,) + hw, dtype=torch.uint8)
    clean = torch.tensor([True, False, True, True])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, image, clean, torch.Generator().manual_seed(1))
    spans = _spans(prof, tmp_path)
    (whole,) = _named(spans, "train.step")
    phases = [s for s in spans if s[0] in ("train.forward", "train.backward", "optim.update")]
    assert [s[0] for s in phases] == ["train.forward", "train.backward"] * 2 + ["optim.update"]
    assert all(_inside(s, whole) for s in phases)
    unet = _named(spans, "unet.forward")
    assert len(unet) == 2 and all(any(_inside(u, f) for f in _named(spans, "train.forward")) for u in unet)


def test_pipeline_spans(tmp_path):
    """A 3-step chain: three ``sampler.step``, each holding one
    ``unet.forward`` that holds the UNet's blocks in order."""
    pipe = DiffusionPipeline(UNet2DModel(TINY, device="cpu"), DDPMScheduler(DDPMConfig()), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe(batch_size=2, generator=torch.Generator().manual_seed(0), num_inference_steps=3, output_type="pt")
    spans = _spans(prof, tmp_path)
    steps, unet = _named(spans, "sampler.step"), _named(spans, "unet.forward")
    assert len(steps) == len(unet) == 3
    for step, fwd in zip(steps, unet):
        assert _inside(fwd, step)
        blocks = [s for s in spans if s[0].startswith("unet.") and s[0] != "unet.forward" and _inside(s, fwd)]
        assert [s[0] for s in blocks] == BLOCKS


def test_prefetch_spans(tmp_path):
    """The consumer's ``data.wait`` a batch, on its own thread; the feed's
    ``data.stage`` a batch, on the feed's thread, under a profiler that
    records every thread."""
    batches = [{"x": np.full((2, 3), i, np.float32)} for i in range(3)]
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=config) as prof:
        got = [b["x"][0, 0].item() for b in device_prefetch(iter(batches), "cpu", size=1)]
    assert got == [0.0, 1.0, 2.0]
    spans = _spans(prof, tmp_path)
    waits, stages = _named(spans, "data.wait"), _named(spans, "data.stage")
    assert len(waits) == 4  # three batches and the end
    assert len(stages) == 3
    assert {s[3] for s in waits} == {threading.get_native_id()} and {s[3] for s in stages}.isdisjoint({s[3] for s in waits})


# ---------------------------------------------------------------- the benchmark's readers


def _event(cat, name, ts, dur, tid, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, tid, corr):
    return _event("cuda_runtime", "cudaLaunchKernel", ts, 1, tid, corr)


def _kernel(name, ts, dur, corr):
    return _event("kernel", name, ts, dur, 7, corr)


# thread 1 the loop, 2 the autograd engine, 3 the feed (with its span), 4 a thread with no host op
TRAIN = [
    _event("user_annotation", "bench.window", 0, 2000, 1),
    _event("user_annotation", "data.wait", 0, 30, 1),
    _event("user_annotation", "train.step", 40, 1900, 1),
    _event("user_annotation", "train.forward", 50, 300, 1),
    _launch(60, 1, 1), _kernel("conv fwd", 100, 80, 1),
    _event("user_annotation", "train.backward", 400, 600, 1),
    _event("cpu_op", "autograd::engine::evaluate_function: ConvBackward", 420, 500, 2),
    _launch(450, 2, 2), _kernel("conv dgrad", 460, 120, 2),  # the engine's thread, inside the span: counts
    _launch(500, 1, 3), _kernel("grad accumulate", 600, 20, 3),  # the loop's own thread, inside: counts
    _event("user_annotation", "data.stage", 700, 40, 3),
    _launch(710, 3, 4), _event("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 720, 15, 7, 4),  # the feed: left out
    _launch(800, 4, 5), _kernel("unfollowed", 810, 5, 5),  # no host op on its thread: left out
    _launch(1100, 2, 6), _kernel("after the span", 1110, 30, 6),  # launched after the span closed: left out
    _event("user_annotation", "optim.update", 1200, 500, 1),
    _event("cpu_op", "aten::_foreach_add_", 1210, 100, 1),
    _launch(1220, 1, 7), _kernel("multi_tensor_apply_kernel", 1230, 60, 7),
    _launch(1400, 1, 8), _kernel("vector_norm", 1400, 10, 8),
]
SAMPLE = [
    _event("user_annotation", "bench.window", 0, 1000, 1),
    _event("user_annotation", "sampler.step", 10, 400, 1),
    _launch(20, 1, 1), _kernel("scale input", 20, 5, 1),
    _event("user_annotation", "unet.forward", 30, 300, 1),
    _event("user_annotation", "unet.down.0", 40, 100, 1),
    _launch(50, 1, 2), _kernel("conv", 60, 200, 2),
    _launch(340, 1, 3), _kernel("ddpm step", 340, 15, 3),
    _event("user_annotation", "sampler.step", 500, 400, 1),
    _event("user_annotation", "unet.forward", 520, 200, 1),
    _launch(530, 1, 4), _kernel("conv", 540, 100, 4),
    _launch(800, 1, 5), _kernel("ddpm step", 800, 25, 5),
]


def _ctx(events, mode, steps):
    s = sites(dict(block_out_channels=[16, 32], layers_per_block=1, norm_num_groups=8, in_channels=3, out_channels=3,
                   down_block_types=["AttnDownBlock2D", "DownBlock2D"], up_block_types=["UpBlock2D", "AttnUpBlock2D"],
                   attention_head_dim=None), 8)
    return TraceContext(timeline=Timeline(events), mode=mode, dtype="bfloat16", sites=s, steps=steps, rows=4, micro=2,
                        calls=2, rate=10.0, launches={}, flops_per_row=s.product_flops)


@pytest.mark.parametrize("metric, mode, want", [
    ("feed_wait_ms.train", "train", 30e-3 / 2),
    ("forward_device_ms.train", "train", 80e-3 / 2),
    ("backward_device_ms.train", "train", (120 + 20) * 1e-3 / 2),
    ("optim_device_ms.train", "train", (60 + 10) * 1e-3 / 2),
    ("unet_device_ms.sample", "sample", (200 + 100) * 1e-3 / 2),
    ("unet_enqueue_ms.sample", "sample", (300 + 200) * 1e-3 / 2),
    ("scheduler_device_ms.sample", "sample", (5 + 15 + 25) * 1e-3 / 2),
])
def test_readers(metric, mode, want):
    ctx = _ctx(TRAIN if mode == "train" else SAMPLE, mode, 2)
    read = harness.reader(ROOT, metric).read
    assert read(ctx) == pytest.approx(want)
    other = _ctx(SAMPLE if mode == "train" else TRAIN, "sample" if mode == "train" else "train", 2)
    assert read(other) is None  # the other mode's cell reads nothing


@pytest.mark.parametrize("metric, mode", [
    ("feed_wait_ms.train", "train"), ("forward_device_ms.train", "train"), ("backward_device_ms.train", "train"),
    ("optim_device_ms.train", "train"), ("unet_device_ms.sample", "sample"), ("unet_enqueue_ms.sample", "sample"),
    ("scheduler_device_ms.sample", "sample"),
])
def test_readers_find_nothing_in_a_program_without_spans(metric, mode):
    """A program without the spans (the benchmark's own spans only): the
    reader returns None, it does not raise."""
    events = [e for e in (TRAIN if mode == "train" else SAMPLE)
              if e["cat"] != "user_annotation" or e["name"] == "bench.window"]
    assert harness.reader(ROOT, metric).read(_ctx(events, mode, 2)) is None


def test_backward_rule_by_launch_time():
    """The backward's kernels are matched by their launch's time, on any
    thread but the feed's and one the profiler did not follow."""
    read = harness.reader(ROOT, "backward_device_ms.train")
    tl = Timeline(TRAIN)
    assert read.backward_seconds(tl) == pytest.approx(140e-6)
    # the feed's copy counts once its thread ran no data.stage and holds a host op
    unmarked = [dict(e, name="aten::copy_", cat="cpu_op") if e["name"] == "data.stage" else e for e in TRAIN]
    assert read.backward_seconds(Timeline(unmarked)) == pytest.approx(155e-6)


def test_model_init_reader():
    read = harness.reader(ROOT, "model_init_s").read
    ctx = _ctx(SAMPLE, "sample", 2)
    profiling.reset_counters()
    assert read(ctx) is None
    UNet2DModel(TINY, device="cpu")
    UNet2DModel(TINY, device="cpu")
    calls, seconds = profiling.counters()["unet.init"]
    assert calls == 2 and read(ctx) == pytest.approx(seconds / 2) and read(_ctx(TRAIN, "train", 2)) > 0


@pytest.mark.parametrize("metric, mode", [("bias_shift_device_ms.sample", "sample"),
                                          ("bias_shift_device_ms.train", "train")])
def test_bias_shift_readers(metric, mode):
    """The bias-shift kernels' device ms a step, by kernel name; None in a
    program without them (a parent without the pair) and in the other mode."""
    base = TRAIN if mode == "train" else SAMPLE
    events = base + [_launch(900, 1, 20), _kernel("void bias_shift_fwd_kernel<__nv_bfloat16, 8, true>", 900, 40, 20),
                     _launch(950, 1, 21), _kernel("void bias_shift_fold_kernel<float>", 950, 4, 21)]
    read = harness.reader(ROOT, metric).read
    assert read(_ctx(events, mode, 2)) == pytest.approx(44e-3 / 2)
    assert read(_ctx(base, mode, 2)) is None
    assert read(_ctx(events, "train" if mode == "sample" else "sample", 2)) is None
