"""The trace's reading and the per-layer readers on a small made-up Chrome
trace (instant)."""

import os

import pytest

from bench_port import harness
from bench_port.common import TraceContext
from bench_port.trace import Timeline
from bench_port.work.model import k1_bytes, k2_bytes, sites
from bench_port.work.peaks import HBM_BYTES_PER_S

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = {"block_out_channels": [16, 32], "layers_per_block": 1, "norm_num_groups": 8, "in_channels": 3,
        "out_channels": 3, "down_block_types": ["AttnDownBlock2D", "DownBlock2D"],
        "up_block_types": ["UpBlock2D", "AttnUpBlock2D"], "attention_head_dim": None}


def _event(cat, name, ts, dur, tid, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _event("user_annotation", "bench.window", 0, 1000, 1),
    _event("gpu_user_annotation", "bench.window", 0, 1000, 7),
    _event("user_annotation", "bench.data_wait", 5, 20, 1),
    _event("user_annotation", "bench.step", 30, 900, 1),
    _event("cpu_op", "aten::_foreach_add_", 100, 50, 1),
    _event("cuda_runtime", "cudaLaunchKernel", 110, 2, 1, corr=1),
    _event("kernel", "multi_tensor_apply_kernel", 150, 40, 7, corr=1),
    _event("cuda_runtime", "cudaLaunchKernel", 200, 2, 1, corr=2),
    _event("kernel", "void groupnorm_silu_fwd_kernel<bf16>", 180, 100, 8, corr=2),  # overlaps: counts once
    _event("cuda_runtime", "cudaLaunchKernel", 300, 2, 1, corr=3),
    _event("kernel", "void groupnorm_silu_bwd_kernel<bf16>", 400, 50, 7, corr=3),
    _event("gpu_memcpy", "Memcpy HtoD", 500, 10, 7),
    _event("cpu_op", "autograd::engine::evaluate_function: ConvBackward", 600, 200, 2),
    _event("kernel", "outside the window", 2000, 10, 7, corr=9),
]


def test_timeline():
    tl = Timeline(EVENTS)
    assert tl.window_s == pytest.approx(1e-3)
    assert tl.busy_s == pytest.approx((280 - 150 + 50 + 10) * 1e-6)  # [150, 280), [400, 450), [500, 510)
    assert tl.class_seconds("K1") == pytest.approx(100e-6) and tl.class_seconds("K2") == pytest.approx(50e-6)
    assert tl.seconds_under("aten::_foreach_") == pytest.approx(40e-6)
    assert tl.span_seconds("bench.data_wait") == pytest.approx(20e-6)
    gaps = dict(tl.breakdown()["idle_gaps"])
    assert gaps["bench.step > autograd::engine::evaluate_function: ConvBackward"] == pytest.approx(490e-6)
    assert gaps["bench.step"] == pytest.approx((150 + 120 + 50) * 1e-6)  # the host between ops
    assert tl.breakdown()["device_ops"][0] == ["void groupnorm_silu_fwd_kernel<bf16>", pytest.approx(100e-6)]


def test_readers():
    tl = Timeline(EVENTS)
    s = sites(TINY, 8)
    train = TraceContext(timeline=tl, mode="train", dtype="bfloat16", sites=s, steps=2, rows=8, micro=4, calls=2,
                         rate=100.0, launches={}, flops_per_row=3 * s.product_flops)
    sample = TraceContext(timeline=tl, mode="sample", dtype="float32", sites=s, steps=2, rows=8, micro=8, calls=1,
                          rate=100.0, launches={}, flops_per_row=s.product_flops, save_stats=False)
    read = lambda name, ctx: harness.reader(ROOT, name).read(ctx)
    assert read("data_wait_ms.train", train) == pytest.approx(0.01)
    assert read("step_device_ms.train", train) == pytest.approx(tl.busy_s * 1e3 / 2)
    assert read("optimizer_device_ms.train", train) == pytest.approx(0.02)
    assert read("idle_pct.train", train) == pytest.approx(100 * (1 - tl.busy_s / tl.window_s))
    assert read("k1_roofline_pct.train", train) == pytest.approx(
        100 * k1_bytes(s, 4, "bfloat16", True) * 4 / HBM_BYTES_PER_S / 100e-6)
    assert read("k2_roofline_pct.train", train) == pytest.approx(
        100 * k2_bytes(s, 4, "bfloat16") * 4 / HBM_BYTES_PER_S / 50e-6)
    assert read("mfu.sample", sample) == pytest.approx(100 * s.product_flops * 100 / 495e12)
    assert read("k3_roofline_pct.sample", sample) is None  # no K3 kernel in the trace: nothing to read
    assert read("step_device_ms.sample", train) is None and read("data_wait_ms.train", sample) is None
