"""The port's latent-diffusion path against the benchmark's plain reference
(``bench_port/reference/``: ``vq.py``, ``ddim.py``, ``unet.py``), on seeded
random weights at a small size on the CPU: the VQ-VAE's encode and decode
(VQ widths 32/64, 8 codes of 3), the quantizer's plain twin with planted
exact ties, the DDIM step at CompVis/ldm-celebahq-256's β, and a multi-head
LDM-shaped UNet's forward (heads of 8). The one set of weights the
benchmark draws is loaded into the port by name. About 5 s."""

import json
import os

import numpy as np
import pytest
import torch

from baddiffusion_tpu_torch import ops
from baddiffusion_tpu_torch.models.unet2d import UNet2DConfig, UNet2DModel
from baddiffusion_tpu_torch.models.vae import VectorQuantizer, VQModel, VQModelConfig
from baddiffusion_tpu_torch.schedulers import DDIMConfig, DDIMScheduler
from bench_port.common import load_weights
from bench_port.reference import unet as ref_unet
from bench_port.reference import vq as ref_vq
from bench_port.reference.ddim import DDIM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "bench_port", "configs", "ldm-celebahq-256.json")) as f:
    PUBLISHED = json.load(f)
VQ = dict(PUBLISHED["vqvae"], block_out_channels=[32, 64], down_block_types=["DownEncoderBlock2D"] * 2,
          up_block_types=["UpDecoderBlock2D"] * 2, norm_num_groups=8, num_vq_embeddings=8, sample_size=16)
UNET = dict(PUBLISHED["unet"], block_out_channels=[32, 64, 64],
            down_block_types=["DownBlock2D", "AttnDownBlock2D", "AttnDownBlock2D"],
            up_block_types=["AttnUpBlock2D", "AttnUpBlock2D", "UpBlock2D"], attention_head_dim=8,
            norm_num_groups=8, sample_size=8)
CPU = torch.device("cpu")


def _vq(seed=0):
    params = ref_vq.init_params(VQ, torch.Generator().manual_seed(seed), CPU)
    model = VQModel(VQModelConfig(**VQ), device="cpu")
    load_weights(model, params)
    return model, params


def _close(got, want, rel=1e-5):
    torch.testing.assert_close(got, want, atol=rel * want.abs().max().item(), rtol=0.0)


def test_vq_encode_matches_the_reference():
    model, params = _vq()
    x = torch.randn(3, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model.encode(x)
    assert got.shape == (3, 8, 8, 3)
    _close(got, ref_vq.encode(params, VQ, x))


def test_vq_decode_matches_the_reference():
    """Quantize then decode: the same codes and quantized latents as the
    reference quantizer's, and the reference decoder's image."""
    model, params = _vq(2)
    h = 1.5 * torch.randn(3, 8, 8, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        z_q, idx = model.quantize(h)
        got = model.decode(h)
    ref_idx, ref_zq = ref_vq.quantize(params, h, rows=37)
    assert torch.equal(idx, ref_idx) and torch.equal(z_q, ref_zq)
    assert got.shape == (3, 16, 16, 3)
    _close(got, ref_vq.decode(params, VQ, ref_zq))


def test_quantizer_twin_breaks_exact_ties_to_the_lowest_index():
    """Codes repeated in the codebook: a vector on a repeated code, or as far
    from two copies, takes the first, as the reference does; the twin's rows
    are the codebook's, and ``VectorQuantizer`` on the CPU is the twin (no
    launch)."""
    g = torch.Generator().manual_seed(4)
    base = torch.randn(4, 3, generator=g)
    codebook = torch.cat([base, base.flip(0)])  # 8 codes: code 7 - i repeats code i
    z = torch.cat([codebook, 0.5 * (codebook[:4] + codebook[4:]), torch.randn(50, 3, generator=g)])
    ops.reset_launch_counts()
    idx, rows = ops.vq_nearest(z.contiguous(), codebook)
    want = torch.argmin(ref_vq.distances(codebook, z), dim=1)
    assert torch.equal(idx, want) and torch.equal(rows, codebook[idx])
    assert torch.equal(idx[:8], torch.tensor([0, 1, 2, 3, 3, 2, 1, 0]))
    quantizer = VectorQuantizer(8, 3)
    quantizer.embedding.weight.data.copy_(codebook)
    with torch.no_grad():
        z_q, codes = quantizer(z.reshape(2, 31, 1, 3))
    assert torch.equal(codes.reshape(-1), idx) and torch.equal(z_q.reshape(-1, 3), z + (codebook[idx] - z))
    assert ops.launch_counts()["vq_nearest"] == 0


@pytest.mark.parametrize("steps", [50, 7])
def test_ddim_step_matches_the_reference(steps):
    """The port's DDIM at the published scheduler keys against the
    reference's: the same timesteps, each step's x_{k+1} within f32's
    rounding of ᾱ (the port's β are f32, the reference's float64), and the
    reference's coefficient on ε is the step's: x_{k+1} moves by −k·δ."""
    cfg = PUBLISHED["scheduler"]
    port = DDIMScheduler(DDIMConfig(**cfg))
    state = port.set_timesteps(port.create_state(), steps)
    ref = DDIM(cfg)
    assert np.array_equal(np.asarray(state.timesteps), ref.timesteps(steps))
    g = torch.Generator().manual_seed(5)
    x, eps, delta = (torch.randn(2, 8, 8, 3, generator=g) for _ in range(3))
    for i in range(steps):
        t = int(state.timesteps[i])
        _, got, _ = port.step(state, eps, i, x)
        want, k = ref.step(x, eps, t, steps)
        _close(got, want, 2e-6)
        moved = ref.step(x, eps + 1e-2 * delta, t, steps)[0] - want
        _close(moved, -k * 1e-2 * delta, 1e-3)


def test_multi_head_ldm_unet_forward_matches_the_reference():
    params = ref_unet.init_params(UNET, torch.Generator().manual_seed(6), CPU)
    model = UNet2DModel(UNet2DConfig(**UNET), device="cpu")
    load_weights(model, params)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 8, 8, 3, generator=g)
    for t in (0, 500, 980):
        tt = torch.full((2,), t, dtype=torch.long)
        with torch.no_grad():
            got = model(x, tt)
        _close(got, ref_unet.forward(params, UNET, x, tt), 1e-4)
