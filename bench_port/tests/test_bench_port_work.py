"""The yardstick's counts (``bench_port/work``) against the program's calls
and against ``FlopCounterMode`` over the reference (about 5 s)."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port.reference import unet as ref_unet
from bench_port.work import peaks
from bench_port.work.model import k1_bytes, k2_bytes, k3_least_seconds, sites

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = {
    "act_fn": "silu", "attention_head_dim": None, "block_out_channels": [16, 32],
    "center_input_sample": False, "down_block_types": ["AttnDownBlock2D", "DownBlock2D"],
    "downsample_padding": 0, "flip_sin_to_cos": False, "freq_shift": 1, "in_channels": 3,
    "layers_per_block": 1, "mid_block_scale_factor": 1, "norm_eps": 1e-6, "norm_num_groups": 8,
    "out_channels": 3, "sample_size": 8, "time_embedding_type": "positional",
    "up_block_types": ["UpBlock2D", "AttnUpBlock2D"],
}


def _config(name):
    with open(os.path.join(ROOT, "bench_port", "configs", name + ".json")) as f:
        return json.load(f)["unet"]


def _program_calls(cfg, monkeypatch):
    """(K1 shapes, K3 shapes) of one forward of the port's UNet on the meta
    device, its GroupNorm+SiLU and attention calls recorded."""
    from baddiffusion_tpu_torch.models import attention as attention_module
    from baddiffusion_tpu_torch.models import resnet as resnet_module
    from baddiffusion_tpu_torch.models.unet2d import UNet2DConfig, UNet2DModel

    k1, k3 = [], []

    def record_k1(x, weight, bias, groups, eps):
        k1.append((x.shape[1], x.shape[2], x.shape[3], groups))
        return torch.empty_like(x)

    def record_k3(q, k, v, scale):
        k3.append((q.shape[1], q.shape[2], q.shape[3]))
        return torch.empty_like(q)

    monkeypatch.setattr(resnet_module, "groupnorm_silu", record_k1)
    monkeypatch.setattr(attention_module, "attention", record_k3)
    model = UNet2DModel(UNet2DConfig(**cfg), device="meta")
    size = cfg["sample_size"]
    with torch.device("meta"):
        model(torch.empty(2, size, size, cfg["in_channels"]), torch.zeros(2, dtype=torch.long))
    return k1, k3


@pytest.mark.parametrize("name,k1_sites", [("ddpm-cifar10-32", 45), ("ddpm-ema-celebahq-256", 65)])
def test_sites_match_the_programs_calls(name, k1_sites, monkeypatch):
    cfg = _config(name)
    s = sites(cfg, cfg["sample_size"])
    k1, k3 = _program_calls(cfg, monkeypatch)
    assert len(s.gn_silu) == k1_sites
    assert k1 == s.gn_silu
    assert k3 == s.attention and len(k3) == 6


@pytest.mark.parametrize("name", ["ddpm-cifar10-32", "ddpm-ema-celebahq-256"])
def test_reference_names_the_programs_parameters(name):
    from baddiffusion_tpu_torch.models.unet2d import UNet2DConfig, UNet2DModel

    cfg = _config(name)
    model = UNet2DModel(UNet2DConfig(**cfg), device="meta")
    program = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    assert program == [(n, shape) for n, shape, _ in ref_unet.param_spec(cfg)]


def test_model_flops_match_the_flop_counter():
    params = ref_unet.init_params(TINY, torch.Generator().manual_seed(0), torch.device("cpu"))
    x = torch.randn(3, 8, 8, 3)
    with FlopCounterMode(display=False) as counter:
        ref_unet.forward(params, TINY, x, torch.tensor([1, 500, 999]))
    assert counter.get_total_flops() == pytest.approx(3 * sites(TINY, 8).product_flops, rel=1e-12)


def test_published_sizes():
    assert sites(_config("ddpm-cifar10-32"), 32).product_flops == pytest.approx(12.4437e9, rel=1e-4)
    assert sites(_config("ddpm-ema-celebahq-256"), 256).product_flops == pytest.approx(497.03e9, rel=1e-4)


def test_bytes_and_bounds():
    s = sites(TINY, 8)
    n = sum(h * w * c for h, w, c, _ in s.gn_silu)
    c = sum(c for _, _, c, _ in s.gn_silu)
    g = sum(g for *_, g in s.gn_silu)
    assert k1_bytes(s, 2, "bfloat16", False) == 2 * 2 * n * 2 + 8 * c
    assert k1_bytes(s, 2, "float32", True) == 2 * 2 * n * 4 + 8 * c + 2 * 2 * g * 4
    assert k2_bytes(s, 2, "bfloat16") == 3 * 2 * n * 2 + 2 * 2 * g * 4 + 16 * c
    heads, t, d = s.attention[0]
    one = sites(dict(TINY, down_block_types=["DownBlock2D", "DownBlock2D"],
                     up_block_types=["UpBlock2D", "UpBlock2D"]), 8)
    assert len(one.attention) == 1  # the mid block's alone
    least = k3_least_seconds(one, 4, "float32", peaks.FLOPS["float32"], peaks.HBM_BYTES_PER_S)
    (h1, t1, d1), = one.attention
    assert least == max(4 * 4 * h1 * t1 * t1 * d1 / 495e12, 4 * 4 * h1 * t1 * d1 * 4 / 3.35e12)


def test_f32_is_held_to_the_tf32_rate():
    assert peaks.FLOPS == {"bfloat16": 989e12, "float32": 495e12}
    assert peaks.HBM_BYTES_PER_S == 3.35e12
