"""``utils/profiling.py`` on the CPU (a few seconds alone): the port's
counterpart of the JAX module measures device time, not HBM bytes (no tool
that reads the card's byte counters runs where the card is), and on the CPU
it runs under the CPU profiler, naming the device ``"cpu"``. The JAX module
reads a TPU xplane, so there is no JAX side to hold it against."""

import pytest
import torch

from baddiffusion_tpu_torch.ops import groupnorm_silu_plain
from baddiffusion_tpu_torch.utils import profiling


class Small(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(4, 8, 3, padding=1)
        self.dense = torch.nn.Linear(8, 8)

    def forward(self, x):
        y = self.conv(x).permute(0, 2, 3, 1)
        y = groupnorm_silu_plain(y, torch.ones(8), torch.zeros(8), 4)
        return self.dense(y)


def test_measure_device_time_on_the_cpu():
    model, x = Small(), torch.randn(2, 4, 16, 16)
    calls = []

    def run_once():
        calls.append(1)
        return model(x)

    stats = profiling.measure_device_time(run_once, steps=3, device="cpu")
    assert len(calls) == 4  # one warm-up, three profiled
    assert stats["device"] == "cpu" and stats["steps"] == 3
    for key in ("hbm_gib_per_step", "hbm_bytes_per_step", "hbm_gbps_busy", "measured_flops_per_step"):
        assert key in stats and stats[key] is None
    by = stats["by_class"]
    assert list(by) == ["K1", "K2", "K3", "conv", "matmul", "other"]
    assert by["conv"] > 0 and by["matmul"] > 0 and by["other"] > 0
    assert by["K1"] == by["K2"] == by["K3"] == 0.0  # the plain twins run on the CPU, no kernel
    assert stats["device_time_ms_per_step"] == pytest.approx(sum(by.values()))
    assert stats["device_time_ms_per_step"] == pytest.approx(sum(stats["kernels"].values()))
    assert 0.0 < stats["device_time_ms_per_step"] <= stats["wall_ms_per_step"]
    assert 0.0 <= stats["idle_share"] < 1.0
    assert stats["idle_share"] == pytest.approx(1 - stats["device_time_ms_per_step"] / stats["wall_ms_per_step"])


def test_top_device_ops_by_time():
    model, x = Small(), torch.randn(2, 4, 32, 32)
    stats = profiling.measure_device_time(lambda: model(x), steps=2, device="cpu")
    rows = profiling.top_device_ops(stats, k=3)
    assert len(rows) == 3
    times = [ms for _, _, ms in rows]
    assert times == sorted(times, reverse=True) and times[0] == max(stats["kernels"].values())
    assert all(cls == profiling.kernel_class(name) for cls, name, _ in rows)
    assert len(profiling.top_device_ops(stats, k=1000)) == len(stats["kernels"])
    with pytest.raises(ValueError, match="no byte count"):
        profiling.top_device_ops(stats, by="bytes")


@pytest.mark.parametrize("name, cls", [
    ("void groupnorm_silu_fwd_kernel<__nv_bfloat16, 8>(...)", "K1"),
    ("groupnorm_silu_bwd_kernel", "K2"),
    ("sum_rows_kernel(float const*, float*, int, int)", "K2"),
    ("void attention_tiled_kernel<64, 64>(...)", "K3"),
    ("attention_packed_kernel", "K3"),
    ("attention_rowwise_kernel", "K3"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32", "conv"),
    ("aten::mkldnn_convolution", "conv"),
    ("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NTT", "matmul"),
    ("ampere_sgemm_128x64_tn", "matmul"),
    ("aten::addmm", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "other"),
    (profiling.EVENT_TIMED, "other"),
])
def test_kernel_classes(name, cls):
    assert profiling.kernel_class(name) == cls


def test_by_class_sums_and_formats():
    by = profiling.device_time_by_class({"groupnorm_silu_fwd_kernel": 1.0, "sum_rows_kernel": 0.5,
                                         "groupnorm_silu_bwd_kernel": 1.5, "x_gemm": 2.0, "copy": 1.0})
    assert by == {"K1": 1.0, "K2": 2.0, "K3": 0.0, "conv": 0.0, "matmul": 2.0, "other": 1.0}
    text = profiling.format_by_class(by, per=2.0)
    assert text.startswith("K1 0.5000 ms (16.7%), K2 1.0000 ms (33.3%)")


def test_the_card_is_the_default(monkeypatch):
    """No quiet CPU run: without a GPU the default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profiling.measure_device_time(lambda: None, steps=1)
