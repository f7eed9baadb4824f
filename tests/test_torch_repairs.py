"""The port's API gaps against the JAX package, and K3's envelope, on the CPU
(about 15 s alone).

- ``DDPMScheduler.get_velocity`` against the JAX scheduler's (the v-target
  √ᾱ_t·ε − √(1−ᾱ_t)·x₀), atol 1e-6 as the DDIM check has it.
- ``DiffusionPipeline.encode``/``decode``: the identity hooks of the JAX
  pipeline, extra arguments ignored.
- K3's envelope. The port's kernel raises outside T ≤ 4096 and D a multiple
  of 8 in [8, 512]; the JAX ``attention`` computes any shape (outside its
  Pallas envelope it runs its reference). So every configuration the port
  knows is walked, at the image size each path runs it, and every attention
  call it makes is held inside ``_check_envelope``: the UNet forwards run on
  the ``meta`` device (shapes only, no arithmetic), with the GroupNorm+SiLU
  and attention wrappers replaced by recorders. The same walk counts each
  forward's GroupNorm+SiLU (K1) and attention (K3) calls.
"""

import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import baddiffusion_tpu.schedulers as JS
import baddiffusion_tpu_torch.models.attention as attention_module
import baddiffusion_tpu_torch.models.resnet as resnet_module
import baddiffusion_tpu_torch.schedulers as PS
from baddiffusion_tpu.pipelines import DiffusionPipeline as JaxDiffusionPipeline
from baddiffusion_tpu_torch import model_configs as mc
from baddiffusion_tpu_torch import ops
from baddiffusion_tpu_torch.examples.attack_demo import ATTACK_MODEL_CONFIG
from baddiffusion_tpu_torch.examples.train_sde_ve import SCORE_MODEL_CONFIG
from baddiffusion_tpu_torch.models import DEFAULT_SCRATCH_CONFIG, UNet2DConfig, UNet2DModel, VQModel
from baddiffusion_tpu_torch.ops.attention import MAX_D, MAX_T, _check_envelope
from baddiffusion_tpu_torch.pipelines import DiffusionPipeline

B = 2


def test_ddpm_velocity_matches_jax():
    js, ps = JS.DDPMScheduler(JS.DDPMConfig()), PS.DDPMScheduler(PS.DDPMConfig())
    rng = np.random.RandomState(10)
    x0, noise = rng.randn(3, 4, 4, 3).astype(np.float32), rng.randn(3, 4, 4, 3).astype(np.float32)
    t = np.array([0, 487, 999], np.int32)
    want = js.get_velocity(js.create_state(), jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
    got = ps.get_velocity(ps.create_state(), torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_pipeline_encode_decode_are_identity_like_jax():
    unet = UNet2DModel(dataclasses.replace(ATTACK_MODEL_CONFIG, block_out_channels=(32, 32, 32)), device="cpu")
    port = DiffusionPipeline(unet, PS.DDPMScheduler(PS.DDPMConfig()), device="cpu")
    jax_pipe = JaxDiffusionPipeline(None, None, JS.DDPMScheduler(JS.DDPMConfig()))
    x = np.random.RandomState(11).randn(2, 8, 8, 3).astype(np.float32)
    for hook in ("encode", "decode"):
        want = getattr(jax_pipe, hook)(x, 0.18215, generator=None)
        got = getattr(port, hook)(x, 0.18215, generator=None)
        assert got is x and want is x
        xt = torch.from_numpy(x)
        assert getattr(port, hook)(xt) is xt


class MetaWalk:
    """One forward on the ``meta`` device with K1 and K3 replaced by
    recorders: ``k1`` counts the GroupNorm+SiLU calls, ``k3`` lists each
    attention call's ``[B, H, T, D]``, each held to ``_check_envelope``."""

    def __init__(self, monkeypatch):
        self.k1, self.k3 = 0, []

        def k1(x, weight, bias, num_groups, eps=1e-5):
            self.k1 += 1
            return torch.empty_like(x)

        def k3(q, k, v, scale):
            _check_envelope(q.shape[2], q.shape[3], q.dtype)
            self.k3.append(tuple(q.shape))
            return torch.empty_like(q)

        monkeypatch.setattr(resnet_module, "groupnorm_silu", k1)
        monkeypatch.setattr(attention_module, "attention", k3)

    def reset(self):
        self.k1, self.k3 = 0, []

    def shapes(self) -> dict:
        return dict(collections.Counter(self.k3))


def walk_unet(monkeypatch, config: UNet2DConfig, size: int, dtype=torch.float32) -> MetaWalk:
    """K1 calls and K3 shapes of one forward of ``config`` at ``size`` px."""
    walk = MetaWalk(monkeypatch)
    model = UNet2DModel(config, device="meta", dtype=dtype)
    with torch.device("meta"):
        out = model(torch.empty(B, size, size, config.in_channels), torch.empty(B))
    assert out.shape == (B, size, size, config.out_channels)
    return walk


# (config, image size, K1 a forward, {attention [B, H, T, D]: calls a forward})
UNET_WALKS = {
    "scratch-32": (DEFAULT_SCRATCH_CONFIG, 32, 65, {(B, 64, 4, 8): 5, (B, 64, 1, 8): 1}),
    "scratch-256": (DEFAULT_SCRATCH_CONFIG, 256, 65, {(B, 64, 256, 8): 5, (B, 64, 64, 8): 1}),
    "ddpm-cifar10-32": (mc.DDPM_CIFAR10_32, 32, 45, {(B, 1, 256, 256): 5, (B, 1, 16, 256): 1}),
    "ddpm-ema-celebahq-256": (mc.DDPM_EMA_CELEBAHQ_256, 256, 65, {(B, 1, 256, 512): 5, (B, 1, 64, 512): 1}),
    "ldm-celebahq-256-unet": (mc.LDM_CELEBA_HQ_256_UNET, 64, 45,
                              {(B, 14, 1024, 32): 5, (B, 21, 256, 32): 5, (B, 28, 64, 32): 6}),
    "ncsnpp-celebahq-256": (mc.NCSNPP_CELEBA_HQ_256, 256, 105, {(B, 32, 256, 8): 3, (B, 32, 16, 8): 1}),
    "attack-demo": (ATTACK_MODEL_CONFIG, 32, 35, {(B, 16, 256, 8): 5, (B, 32, 64, 8): 1}),
    "score-demo": (SCORE_MODEL_CONFIG, 32, 35, {(B, 16, 256, 8): 5, (B, 32, 64, 8): 1}),
}


@pytest.mark.parametrize("name", sorted(UNET_WALKS))
def test_unet_attention_inside_envelope_and_kernel_calls(monkeypatch, name):
    config, size, k1, k3 = UNET_WALKS[name]
    walk = walk_unet(monkeypatch, config, size)
    assert walk.k1 == k1
    assert walk.shapes() == k3


def test_vqvae_attention_inside_envelope_and_kernel_calls(monkeypatch):
    """The LDM's VQ-VAE at 256 px: one attention a mid block at the 64x64
    latent, [B, 1, 4096, 512] (the envelope's long end); 17 K1 an encode,
    23 a decode."""
    walk = MetaWalk(monkeypatch)
    cfg = mc.LDM_CELEBA_HQ_256_VQ
    vq = VQModel(cfg, device="meta")
    with torch.device("meta"):
        z = vq.encode(torch.empty(B, cfg.sample_size, cfg.sample_size, 3))
        assert (walk.k1, walk.shapes()) == (17, {(B, 1, 4096, 512): 1})
        walk.reset()
        x = vq.decode(z)
    assert x.shape == (B, cfg.sample_size, cfg.sample_size, 3)
    assert (walk.k1, walk.shapes()) == (23, {(B, 1, 4096, 512): 1})


@pytest.mark.parametrize("t, d", [(MAX_T + 1, 64), (256, MAX_D + 8)])
def test_attention_outside_envelope_raises(t, d):
    """T = 4097 and D = 520 raise with the envelope message: on a CUDA
    tensor the wrapper checks before any launch, and the plan refuses them
    (no quiet plain path on the card)."""
    with pytest.raises(ValueError, match=r"attention kernel envelope is T <= 4096, D in \[8, 512\]"):
        ops.attention_plan(2, t, d, torch.bfloat16)
    with pytest.raises(ValueError, match=r"attention kernel envelope is T <= 4096, D in \[8, 512\]"):
        _check_envelope(t, d, torch.float32)
