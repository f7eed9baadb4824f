"""The port's VQ-VAE, KL-VAE and LDMPipeline against the JAX package on the
CPU: encode, quantize and decode on ``tests/test_vae_ldm.py``'s TINY_VQ,
AutoencoderKL, the latent DDIM chain with JAX's initial latent handed in,
the pixel-space init encoded to latents, the HF layout written by each
package and read by the other, the factory's LDM branch (scheduler override
and refusal), and the CLI's sampling and measure modes on a staged LDM run
directory. Inputs are seeded with numpy; weights go through
``state_dict_from_jax``."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

import baddiffusion_tpu_torch.metrics.fid  # noqa: F401  (the module, which the package's fid() shadows)
from baddiffusion_tpu import factory as jax_factory
from baddiffusion_tpu.io.hf import flax_to_torch_state_dict
from baddiffusion_tpu.models import AutoencoderKL as JaxAutoencoderKL
from baddiffusion_tpu.models import AutoencoderKLConfig as JaxAutoencoderKLConfig
from baddiffusion_tpu.models import UNet2DConfig as JaxUNet2DConfig
from baddiffusion_tpu.models import UNet2DModel as JaxUNet2DModel
from baddiffusion_tpu.models import VQModel as JaxVQModel
from baddiffusion_tpu.models import VQModelConfig as JaxVQModelConfig
from baddiffusion_tpu.pipelines import LDMPipeline as JaxLDMPipeline
from baddiffusion_tpu.schedulers import DDIMConfig as JaxDDIMConfig
from baddiffusion_tpu.schedulers import DDIMScheduler as JaxDDIMScheduler
from baddiffusion_tpu_torch import cli, factory
from baddiffusion_tpu_torch.io import state_dict_from_jax
from baddiffusion_tpu_torch.model_configs import stage_ldm
from baddiffusion_tpu_torch.models import (
    AttentionBlock,
    AutoencoderKL,
    AutoencoderKLConfig,
    GroupNorm,
    UNet2DConfig,
    UNet2DModel,
    VQModel,
    VQModelConfig,
)
from baddiffusion_tpu_torch.pipelines import LDMPipeline
from baddiffusion_tpu_torch.schedulers import DDIMConfig, DDIMScheduler

# tests/test_vae_ldm.py's tiny LDM: a 16 px VQ-VAE (one downsample: 8 px latents) and an 8 px UNet
TINY_VQ = dict(
    block_out_channels=(8, 16),
    down_block_types=("DownEncoderBlock2D", "DownEncoderBlock2D"),
    up_block_types=("UpDecoderBlock2D", "UpDecoderBlock2D"),
    layers_per_block=1,
    latent_channels=3,
    num_vq_embeddings=32,
    norm_num_groups=4,
    sample_size=16,
)
TINY_UNET = dict(
    sample_size=8,
    in_channels=3,
    out_channels=3,
    layers_per_block=1,
    block_out_channels=(8, 16),
    down_block_types=("DownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "UpBlock2D"),
    norm_num_groups=4,
)
STEPS = 5


@pytest.fixture(autouse=True)
def few_threads():
    """Two threads a BLAS/OpenMP pool: the suite runs several workers at once."""
    with threadpool_limits(limits=2):
        yield


@pytest.fixture(autouse=True)
def quiet_trackers(monkeypatch):
    """Trackers without tensorboard (importing it pulls TensorFlow in)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _nontrivial(params):
    """Norm affines away from 1 and 0, so a scale/bias mix-up cannot pass."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a * 1.1 + 0.05 if path[-1].key in ("scale", "bias") else a, jax.device_get(params))


def _load(module, params):
    module.load_state_dict(state_dict_from_jax(jax.device_get(params)), strict=True)
    return module


def _x(seed=0, batch=2):
    return np.random.RandomState(seed).randn(batch, 16, 16, 3).astype(np.float32)


@pytest.fixture(scope="module")
def jax_ldm():
    """The JAX tiny LDM (seeded, norm affines made non-trivial), made once."""
    vq = JaxVQModel(JaxVQModelConfig(**TINY_VQ))
    vq_params = _nontrivial(jax.jit(vq.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"])
    unet = JaxUNet2DModel(JaxUNet2DConfig(**TINY_UNET))
    unet_params = _nontrivial(jax.jit(lambda k: unet.init_params(k, 8))(jax.random.PRNGKey(1)))
    sched = JaxDDIMScheduler(JaxDDIMConfig(beta_schedule="scaled_linear"))
    return JaxLDMPipeline(vq, vq_params, unet, unet_params, sched)


def _port_ldm(jp) -> LDMPipeline:
    vq = _load(VQModel(VQModelConfig(**TINY_VQ), device="cpu"), jp.vqvae_params)
    unet = _load(UNet2DModel(UNet2DConfig(**TINY_UNET), device="cpu"), jp.params)
    return LDMPipeline(vq, unet, DDIMScheduler(DDIMConfig(beta_schedule="scaled_linear")), device="cpu")


def _close(got, want, atol: float):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0.0)


def test_vq_encode_quantize_decode_match_jax(jax_ldm):
    """f32, atol 1e-5; the codebook indices equal."""
    jvq, jp = jax_ldm.vqvae, jax_ldm.vqvae_params
    port = _port_ldm(jax_ldm).vqvae
    x = _x()
    z_j = jax.jit(lambda p, x: jvq.apply({"params": p}, x, method=jvq.encode))(jp, jnp.asarray(x))
    z = port.encode(torch.from_numpy(x))
    _close(z.detach(), z_j, 1e-5)
    zq_j, idx_j = jax.jit(lambda p, z: jvq.apply({"params": p}, z, method=lambda m, z: m.quantize(z)))(jp, z_j)
    zq, idx = port.quantize(torch.from_numpy(np.array(z_j)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    _close(zq.detach(), zq_j, 1e-5)
    codebook = port.quantize.embedding.weight.detach()
    _close(zq.detach(), codebook[idx].numpy(), 1e-6)  # every vector a codebook row
    for force in (False, True):
        y_j = jax.jit(lambda p, z: jvq.apply({"params": p}, z, force, method=jvq.decode))(jp, z_j)
        y = port.decode(torch.from_numpy(np.array(z_j)), force_not_quantize=force)
        assert y.shape == (2, 16, 16, 3)
        _close(y.detach(), y_j, 1e-5)


def test_vq_gradient_is_straight_through():
    q = VQModel(VQModelConfig(**TINY_VQ), device="cpu").quantize
    z = torch.randn(2, 4, 4, 3, requires_grad=True)
    zq, _ = q(z)
    (zq * torch.arange(3.0)).sum().backward()
    torch.testing.assert_close(z.grad, torch.arange(3.0).expand(2, 4, 4, 3))


def test_autoencoder_kl_matches_jax():
    cfg = dict(TINY_VQ, latent_channels=4)
    del cfg["num_vq_embeddings"]
    jm = JaxAutoencoderKL(JaxAutoencoderKLConfig(**cfg))
    params = _nontrivial(jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.zeros((1, 16, 16, 3)))["params"])
    port = _load(AutoencoderKL(AutoencoderKLConfig(**cfg), device="cpu"), params)
    x = _x(3)
    (mean_j, logvar_j), y_j, y_noisy_j = jax.jit(lambda p, x: (
        jm.apply({"params": p}, x, method=jm.encode), jm.apply({"params": p}, x),
        jm.apply({"params": p}, x, jax.random.PRNGKey(4))))(params, jnp.asarray(x))
    mean, logvar = port.encode(torch.from_numpy(x))
    _close(mean.detach(), mean_j, 1e-5)
    _close(logvar.detach(), logvar_j, 1e-5)
    _close(port(torch.from_numpy(x)).detach(), y_j, 1e-5)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(4), mean_j.shape))  # writable, for torch.from_numpy
    _close(port(torch.from_numpy(x), torch.from_numpy(noise)).detach(), y_noisy_j, 1e-5)


def test_ldm_ddim_chain_matches_jax(jax_ldm):
    """η = 0 DDIM draws nothing past the initial latent, so JAX's initial
    latent handed in makes the two chains the same: images and the decoded
    movie (one frame a step at 5 steps) within atol 1e-4."""
    init = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (2, 8, 8, 3), jnp.float32))
    want = jax_ldm(init=init, num_inference_steps=STEPS, save_every_step=True)
    port = _port_ldm(jax_ldm)
    got = port(init=init, num_inference_steps=STEPS, save_every_step=True)
    assert got.images.shape == (2, 16, 16, 3) and got.movie.shape == want.movie.shape == (STEPS, 2, 16, 16, 3)
    _close(got.images, want.images, 1e-4)
    _close(got.movie, want.movie, 1e-4)
    np.testing.assert_array_equal(got.movie[-1], got.images)
    # without an init the chain starts from latent noise of the latent shape
    out = port(batch_size=3, generator=torch.Generator().manual_seed(0), num_inference_steps=2)
    assert out.images.shape == (3, 16, 16, 3) and 0.0 <= out.images.min() and out.images.max() <= 1.0


def test_pixel_init_is_encoded_to_latents(jax_ldm):
    """A pixel-shaped init (noise + trigger from the measure) is VQ-encoded
    before the chain: the same images as a latent init of its encoding, and
    as JAX's pixel-init chain (atol 1e-4)."""
    port = _port_ldm(jax_ldm)
    assert port.sample_shape(2) == (2, 16, 16, 3) and port.latent_shape(2) == (2, 8, 8, 3)
    pix = _x(6)
    got = port(init=pix, num_inference_steps=STEPS).images
    latent = port.encode(torch.from_numpy(pix))
    _close(latent, jax_ldm.encode(jnp.asarray(pix)), 1e-5)
    _close(port(init=latent, num_inference_steps=STEPS).images, got, 1e-6)
    _close(got, jax_ldm(init=pix, num_inference_steps=STEPS).images, 1e-4)
    # decode divides the decoded image by the scaling factor, as the reference does
    torch.testing.assert_close(port.decode(latent, scaling_factor=0.5), 2.0 * port.decode(latent))


def test_hf_layout_round_trips_both_ways(jax_ldm, tmp_path):
    """The port writes, the JAX package reads, and the reverse: the same
    model index, tensors and images."""
    port = _port_ldm(jax_ldm)
    port.save_pretrained(str(tmp_path / "port"))
    with open(tmp_path / "port" / "model_index.json") as f:
        index = json.load(f)
    assert index["_class_name"] == "LDMPipeline" and index["vqvae"] == ["diffusers", "VQModel"]
    assert {"unet", "vqvae", "scheduler", "model_index.json"} <= set(os.listdir(tmp_path / "port"))
    init = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (1, 8, 8, 3), jnp.float32))
    want = port(init=init, num_inference_steps=3).images
    jax_read = JaxLDMPipeline.from_pretrained(str(tmp_path / "port"))
    _close(jax_read(init=init, num_inference_steps=3).images, want, 1e-4)

    jax_ldm.save_pretrained(str(tmp_path / "jax"))
    read = LDMPipeline.from_pretrained(str(tmp_path / "jax"), device="cpu")
    for model, params in ((read.vqvae, jax_ldm.vqvae_params), (read.unet, jax_ldm.params)):
        sd = flax_to_torch_state_dict(jax.device_get(params))
        assert sorted(model.state_dict()) == sorted(sd)
        for k, v in model.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    assert read.vqvae.config == VQModelConfig(**TINY_VQ) and read.scheduler.config == port.scheduler.config
    _close(read(init=init, num_inference_steps=3).images, want, 1e-6)


def test_factory_ldm_branch_override_and_refusal(jax_ldm, tmp_path):
    """An LDM dir gives LDM pipelines with its own scheduler, or the asked
    one on the CLI's linear betas, as the JAX factory builds it; SDE-VE and
    Karras-VE are refused."""
    path = str(tmp_path / "ldm")
    _port_ldm(jax_ldm).save_pretrained(path)
    unet, sched, get_pipeline = factory.get_pretrained(path, dtype=torch.float32, device="cpu")
    pipe = get_pipeline(sched, device="cpu")
    assert isinstance(pipe, LDMPipeline) and pipe.unet is unet and sched.config.beta_schedule == "scaled_linear"
    assert pipe(batch_size=1, num_inference_steps=2).images.shape == (1, 16, 16, 3)
    _, sched, _ = factory.get_pretrained(path, noise_sched_type="DDIM-SCHED", device="cpu")
    _, _, jax_sched, _ = jax_factory.get_pretrained(path, noise_sched_type="DDIM-SCHED")
    assert isinstance(sched, DDIMScheduler) and sched.config.beta_schedule == "linear"
    assert (sched.config.beta_start, sched.config.beta_end) == (jax_sched.config.beta_start, jax_sched.config.beta_end)
    with pytest.raises(NotImplementedError, match="LDM"):
        factory.get_pretrained(path, noise_sched_type="SCORE-SDE-VE-SCHED", device="cpu")
    with pytest.raises(NotImplementedError, match="scheduler"):
        factory.get_pretrained(path, noise_sched_type="KARRAS-VE-SCHED", device="cpu")
    clipped = factory.get_trained(path, clip_sample=True, device="cpu")[2](sched, device="cpu")
    assert clipped.clip_sample and not pipe.clip_sample


def test_full_width_ldm_kernel_calls():
    """CompVis/ldm-celebahq-256's kernel calls, from the built modules: the
    UNet 45 GroupNorm+SiLU (two a resnet over 8 + 2 + 12 resnets, and
    conv_norm_out) and 16 attention calls (6 down, 1 mid, 9 up); the VQ
    decoder 23 and 1 (two a resnet over 2 + 9, and conv_norm_out), the
    encoder 17 and 1 (over 6 + 2)."""
    from baddiffusion_tpu_torch.model_configs import LDM_CELEBA_HQ_256_UNET, LDM_CELEBA_HQ_256_VQ

    def counts(module):
        return (sum(isinstance(m, GroupNorm) and m.silu for m in module.modules()),
                sum(isinstance(m, AttentionBlock) for m in module.modules()))

    with torch.device("meta"):
        unet = UNet2DModel.__new__(UNet2DModel)
        torch.nn.Module.__init__(unet)
        unet._build(LDM_CELEBA_HQ_256_UNET)
        vq = VQModel.__new__(VQModel)
        torch.nn.Module.__init__(vq)
        vq._build(LDM_CELEBA_HQ_256_VQ)
    assert counts(unet) == (45, 16) and counts(vq.decoder) == (23, 1) and counts(vq.encoder) == (17, 1)
    assert sum(p.numel() for p in unet.parameters()) == 274_056_163
    assert sum(p.numel() for p in vq.parameters()) == 55_322_782


def _small_proxy(monkeypatch, dim=64):
    """The port's default FID extractor as the proxy with a ``dim``-wide
    projection, so the Fréchet distance's sqrtm is dim²."""
    port_fid = sys.modules["baddiffusion_tpu_torch.metrics.fid"]
    monkeypatch.setattr(port_fid, "default_extractor", lambda device=None: (port_fid.proxy_extractor(device, dim), dim))


def test_cli_sampling_and_measure_on_a_staged_ldm_run(tmp_path, monkeypatch):
    """``stage_ldm`` writes a seeded tiny LDM run (16 px FAKE images, 8 px
    latents); ``--mode sampling`` writes its grids and ``--mode measure``
    its 8 + 8 images and score.json, the pixel-space noise + trigger encoded
    to latents on the way."""
    _small_proxy(monkeypatch)
    monkeypatch.chdir(tmp_path)
    run = str(tmp_path / "ldm_run")
    stage_ldm(run, UNet2DConfig(**TINY_UNET), VQModelConfig(**TINY_VQ), DDIMConfig(beta_schedule="scaled_linear"),
              device="cpu", fake_size=32)
    cli.main(["--mode", "sampling", "--ckpt", run, "--gpu", "cpu"])
    for sub in ("samples", "backdoor_samples"):
        assert os.path.exists(os.path.join(run, sub, "epfinal_noclip.png")), sub
    cli.main(["--mode", "measure", "--ckpt", run, "--gpu", "cpu", "--measure_sample_n", "8", "--eval_max_batch", "8",
              "--measure_steps", "5"])
    for sub in ("clean_noclip", "backdoor_noclip"):
        files = os.listdir(os.path.join(run, "measure", sub))
        assert len(files) == 8 and Image.open(os.path.join(run, "measure", sub, files[0])).size == (16, 16)
    with open(os.path.join(run, "score.json")) as f:
        score = json.load(f)
    assert set(score) == {"FID_proxy_noclip", "MSE_noclip", "SSIM_noclip"} and all(np.isfinite(list(score.values())))
