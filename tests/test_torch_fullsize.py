"""google/ddpm-cifar10-32 and google/ddpm-ema-celebahq-256 at full width,
the JAX package against the port on the CPU (about 60 s alone, most of it
the JAX side's init and forward compiles at 113.7M parameters).

- ``model_configs.DDPM_CIFAR10_32`` / ``DDPM_EMA_CELEBAHQ_256`` are the
  published ``unet/config.json`` files field for field (the dicts of
  ``tests/test_fullsize_interop.py``).
- The JAX package writes a seeded pipeline directory at each config (its
  ``DiffusionPipeline.save_pretrained``); the port loads it through
  ``factory.get_pretrained``, and its safetensors into a fresh UNet with
  ``load_state_dict(strict=True)``.
- The f32 forward at a 32 px input (the UNet is fully convolutional: every
  parameter tensor is exercised, the attention at 2x2 or 16x16) against the
  JAX forward: atol 1e-4·max|y| (f32 sums in another order through 22 or
  32 resnets).
- K1, K2 and K3 calls of a forward and of a backward, counted on the CPU
  through the wrappers' plain paths: (45, 45, 6) and (65, 65, 6); and the
  plans K3 takes at the path's shapes (``tiled`` in bf16 and ``tf32x3`` in
  f32 for the 256-wide head, ``wide`` and ``tf32x3`` for the 512-wide).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_fullsize_interop import DDPM_CIFAR10_32 as HUB_CIFAR10_32
from test_fullsize_interop import DDPM_EMA_CELEBAHQ_256 as HUB_CELEBAHQ_256
from threadpoolctl import threadpool_limits

import baddiffusion_tpu.schedulers as JS
import baddiffusion_tpu_torch.models.attention as attention_module
import baddiffusion_tpu_torch.ops.groupnorm as groupnorm_module
from baddiffusion_tpu.models import UNet2DConfig as JaxUNet2DConfig
from baddiffusion_tpu.models import UNet2DModel as JaxUNet2DModel
from baddiffusion_tpu.pipelines import DiffusionPipeline as JaxDiffusionPipeline
from baddiffusion_tpu_torch import factory, ops
from baddiffusion_tpu_torch import model_configs as mc
from baddiffusion_tpu_torch.io.hf import load_torch_state_dict
from baddiffusion_tpu_torch.models import UNet2DModel
from baddiffusion_tpu_torch.pipelines import DiffusionPipeline
from baddiffusion_tpu_torch.schedulers import DDPMConfig, DDPMScheduler

CONFIGS = {
    "ddpm-cifar10-32": (mc.DDPM_CIFAR10_32, HUB_CIFAR10_32, 35_746_307),
    "ddpm-ema-celebahq-256": (mc.DDPM_EMA_CELEBAHQ_256, HUB_CELEBAHQ_256, 113_673_219),
}
# (K1 a forward, K2 a backward, K3 a forward), and K3's [B, H, T, D] at the
# path's own size with the plan each dtype takes
KERNEL_CALLS = {"ddpm-cifar10-32": (45, 45, 6), "ddpm-ema-celebahq-256": (65, 65, 6)}
K3_PLANS = {
    "ddpm-cifar10-32": {(128, 1, 256, 256): ("tiled", "tf32x3"), (128, 1, 16, 256): ("tiled", "tf32x3")},
    "ddpm-ema-celebahq-256": {(8, 1, 256, 512): ("wide", "tf32x3"), (8, 1, 64, 512): ("wide", "tf32x3")},
}


@pytest.fixture(autouse=True)
def few_threads():
    """Two threads a BLAS/OpenMP pool: the suite runs several workers at once."""
    with threadpool_limits(limits=2):
        yield


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_is_the_published_one(name):
    config, hub, _ = CONFIGS[name]
    d = dataclasses.asdict(config)
    for key, value in hub.items():
        assert d[key] == (tuple(value) if isinstance(value, list) else value), key


def _nontrivial(params):
    """Norm affines away from 1 and 0, so a scale/bias mix-up cannot pass."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a * 1.1 + 0.05 if path[-1].key in ("scale", "bias") else a, jax.device_get(params))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_jax_written_dir_loads_and_forward_matches_jax(name, tmp_path):
    config, _, n_params = CONFIGS[name]
    jax_model = JaxUNet2DModel(JaxUNet2DConfig(**dataclasses.asdict(config)))
    params = _nontrivial(jax.jit(lambda k: jax_model.init_params(k, 32))(jax.random.PRNGKey(7)))
    run = str(tmp_path / name)
    JaxDiffusionPipeline(jax_model, params, JS.DDPMScheduler(JS.DDPMConfig())).save_pretrained(run)
    with open(os.path.join(run, "args.json"), "w") as f:
        json.dump({"mode": "train", "dataset": "FAKE", "ckpt": run}, f)

    model, scheduler, get_pipeline = factory.get_pretrained(run, dtype=torch.float32, device="cpu")
    assert model.config == config and sum(p.numel() for p in model.parameters()) == n_params
    assert isinstance(scheduler, DDPMScheduler) and scheduler.config == DDPMConfig()
    pipe = get_pipeline(scheduler, device="cpu")
    assert isinstance(pipe, DiffusionPipeline) and pipe.hf_class_name == "DDPMPipeline"
    fresh = UNet2DModel(config, device="cpu")
    fresh.load_state_dict(load_torch_state_dict(os.path.join(run, "unet")), strict=True)
    sd_a, sd_b = fresh.state_dict(), model.state_dict()
    assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)

    rng = np.random.RandomState(8)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    t = np.asarray([10, 900], np.int32)
    want = np.asarray(jax.jit(jax_model.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernel_calls_of_a_train_step(name, monkeypatch):
    """Counted through the wrappers: every GroupNorm+SiLU forward that keeps
    its statistics for a backward (K1), every backward of one (K2), every
    attention call (K3), over one forward and backward at 32 px."""
    counts = {"k1": 0, "k2": 0, "k3": 0}

    def counting(key, fn):
        def wrapper(*args, **kwargs):
            counts[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(groupnorm_module, "groupnorm_silu_forward",
                        counting("k1", groupnorm_module.groupnorm_silu_forward))
    monkeypatch.setattr(groupnorm_module, "groupnorm_silu_backward",
                        counting("k2", groupnorm_module.groupnorm_silu_backward))
    monkeypatch.setattr(attention_module, "attention", counting("k3", attention_module.attention))
    config = CONFIGS[name][0]
    model = UNet2DModel(config, device="cpu", generator=torch.Generator().manual_seed(9))
    x = torch.randn(1, 32, 32, 3, generator=torch.Generator().manual_seed(10))
    loss = model(x, torch.tensor([500])).square().mean()
    k1, k3 = counts["k1"], counts["k3"]
    loss.backward()
    assert (k1, counts["k2"], k3) == KERNEL_CALLS[name]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_k3_plans_at_the_path_shapes(name):
    for (b, h, t, d), variants in K3_PLANS[name].items():
        got = tuple(ops.attention_plan(b * h, t, d, dtype).variant for dtype in (torch.bfloat16, torch.float32))
        assert got == variants, (b, h, t, d)
