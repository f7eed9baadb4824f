"""The ``ldm-celebahq-256.measure`` cell's comparison on the CPU: the cell
run through the harness with the configuration's widths cut small (its file
replaced in a copy of the checkout) and small traffic overrides. A sound run
is correct; the control (the reference in bf16 in the program's place) and
each planted fault are not. Then ``work/vq.py``'s counts against the port's
calls and the flop counter. About 30 s."""

import json
import os
import shutil
import time

import pytest
import torch

from bench_port import control, faults, harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "ldm-celebahq-256.measure"
SMALL = dict(batch=4, clean_rows=2, chain_steps=10, warm_steps=1, snapshot_every=2, trace_steps=1,
             reference_rows=2)


@pytest.fixture(scope="module")
def ldm_root(tmp_path_factory):
    """A checkout whose ``ldm-celebahq-256`` configuration has small widths:
    a UNet of 32/64 channels with heads of 8 at an 8 px latent, a VQ-VAE of
    32/64 channels at 16 px with 512 codes of 3."""
    root = tmp_path_factory.mktemp("ldm") / "checkout"
    shutil.copytree(os.path.join(ROOT, "bench_port"), root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "baddiffusion_tpu_torch"), root / "baddiffusion_tpu_torch")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    path = root / "bench_port" / "configs" / "ldm-celebahq-256.json"
    config = json.loads(path.read_text())
    config["unet"].update(block_out_channels=[32, 64], down_block_types=["DownBlock2D", "AttnDownBlock2D"],
                          up_block_types=["AttnUpBlock2D", "UpBlock2D"], attention_head_dim=8, norm_num_groups=8,
                          layers_per_block=1, sample_size=8)
    config["vqvae"].update(block_out_channels=[32, 64], down_block_types=["DownEncoderBlock2D"] * 2,
                           up_block_types=["UpDecoderBlock2D"] * 2, layers_per_block=1, norm_num_groups=8,
                           num_vq_embeddings=512, sample_size=16)
    path.write_text(json.dumps(config))
    return str(root)


def _run(root, seed=11):
    torch.manual_seed(0)
    return harness.run_cell(root, CELL, seed, 0.5, False, torch.device("cpu"), time.time(), overrides=SMALL)


def test_sound_run_is_correct(ldm_root):
    result = _run(ldm_root)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"init_gap", "latent_gap", "eps_gap", "step_gap", "code_gap", "quant_gap",
                                       "image_gap"}


def test_control_is_not_correct(ldm_root):
    torch.manual_seed(0)
    row = control.readings(ldm_root, CELL, 11, 0.5, torch.device("cpu"), overrides=SMALL)
    assert row["program_correct"] and not row["lower_correct"], (row["program"], row["lower"])


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_not_correct(fault, ldm_root):
    """Each of ``bench_port.faults``' planted faults fails a limit: a row
    left unstepped ``step_gap``, a code swapped ``code_gap``, a quantized row
    wrong beside its right code ``quant_gap``, an image altered
    ``image_gap``."""
    with faults.FAULTS[fault]():
        result = _run(ldm_root)
    assert not result["correct"], result["checks"]


def test_traced_run_reads_the_vq_metrics(ldm_root):
    """A traced run on the CPU: the VQ readers find the program's ``vq.``
    spans; the kernel's share reads nothing without the CUDA kernel."""
    torch.manual_seed(0)
    result = harness.run_cell(ldm_root, CELL, 12, 0.5, True, torch.device("cpu"), time.time(), overrides=SMALL)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert "vq_nearest_roofline_pct.ldm" not in metrics and metrics["mfu.sample"]["value"] > 0


def _published():
    with open(os.path.join(ROOT, "bench_port", "configs", "ldm-celebahq-256.json")) as f:
        return json.load(f)


def test_vq_sites_match_the_programs_calls(monkeypatch):
    """``work/vq.py``'s K1 and K3 sites are the calls the port's VQ-VAE
    makes at the published widths (on the meta device): 17 K1 and one K3 an
    encode, 23 and one a decode."""
    from baddiffusion_tpu_torch.models import attention as attention_module
    from baddiffusion_tpu_torch.models import resnet as resnet_module
    from baddiffusion_tpu_torch.models.vae import VQModel, VQModelConfig
    from bench_port.work.vq import vq_sites

    k1, k3 = [], []

    def record_k1(x, weight, bias, groups, eps):
        k1.append((x.shape[1], x.shape[2], x.shape[3], groups))
        return torch.empty_like(x)

    def record_k3(q, k, v, scale):
        k3.append((q.shape[1], q.shape[2], q.shape[3]))
        return torch.empty_like(q)

    monkeypatch.setattr(resnet_module, "groupnorm_silu", record_k1)
    monkeypatch.setattr(attention_module, "attention", record_k3)
    cfg = _published()["vqvae"]
    model = VQModel(VQModelConfig(**cfg), device="meta")
    s = vq_sites(cfg)
    with torch.device("meta"):
        latents = model.encode(torch.empty(2, 256, 256, 3))
        assert (k1, k3) == (s.encode_gn_silu, s.encode_attention)
        k1.clear(), k3.clear()
        model.decoder(model.post_quant_conv(latents))
    assert (k1, k3) == (s.decode_gn_silu, s.decode_attention)
    assert (len(s.encode_gn_silu), len(s.decode_gn_silu)) == (17, 23) and s.latent_size == 64


def test_vq_flops_match_the_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode

    from bench_port.reference import vq as ref_vq
    from bench_port.work.vq import vq_sites

    cfg = dict(_published()["vqvae"], block_out_channels=[16, 32], down_block_types=["DownEncoderBlock2D"] * 2,
               up_block_types=["UpDecoderBlock2D"] * 2, norm_num_groups=8, num_vq_embeddings=8, sample_size=16)
    params = ref_vq.init_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    s = vq_sites(cfg)
    with FlopCounterMode(display=False) as counter:
        latents = ref_vq.encode(params, cfg, torch.randn(3, 16, 16, 3))
    assert counter.get_total_flops() == pytest.approx(3 * s.encode_flops, rel=1e-12)
    with FlopCounterMode(display=False) as counter:
        ref_vq.decode(params, cfg, latents)
    assert counter.get_total_flops() == pytest.approx(3 * s.decode_flops, rel=1e-12)


def test_reference_names_the_programs_vq_parameters():
    from baddiffusion_tpu_torch.models.vae import VQModel, VQModelConfig
    from bench_port.reference import vq as ref_vq

    cfg = _published()["vqvae"]
    program = {n: tuple(p.shape) for n, p in VQModel(VQModelConfig(**cfg), device="meta").named_parameters()}
    assert program == {n: shape for n, shape, _ in ref_vq.param_spec(cfg)}


def test_published_vq_sizes():
    from bench_port.work.vq import quantize_least_seconds, vq_sites

    s = vq_sites(_published()["vqvae"])
    assert (s.encode_flops, s.decode_flops) == pytest.approx((345.2374e9, 670.5812e9), rel=1e-6)
    assert quantize_least_seconds(s, 256 * 64 * 64) == pytest.approx(2 * 3 * 8192 * (1 << 20) / 495e12)
