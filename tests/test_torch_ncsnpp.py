"""The port's NCSN++ family and VE score matching against the JAX package on
the CPU: FIR resampling (``upfirdn2d``, ``FirUpsample2D``/``FirDownsample2D``),
``ResnetBlock2D``'s up/down for each resampling kernel, the skip-block UNet
(the JAX tests' ``TINY_NCSNPP``), the three class-embedding types, the
full-width google/ncsnpp-celebahq-256 parameter set and its kernel calls,
and the VE denoising-score-matching step with JAX's own draws handed in.
Inputs are seeded with numpy; weights go through ``state_dict_from_jax``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from baddiffusion_tpu.io.hf import flax_to_torch_state_dict
from baddiffusion_tpu.models import UNet2DConfig as JaxUNet2DConfig
from baddiffusion_tpu.models import UNet2DModel as JaxUNet2DModel
from baddiffusion_tpu.models import resnet as jax_resnet
from baddiffusion_tpu.schedulers import ScoreSdeVeConfig as JaxScoreSdeVeConfig
from baddiffusion_tpu.schedulers import ScoreSdeVeScheduler as JaxScoreSdeVeScheduler
from baddiffusion_tpu.training import create_score_train_state as jax_create_score_train_state
from baddiffusion_tpu.training import make_ve_train_step as jax_make_ve_train_step
from baddiffusion_tpu.training.optim import make_optimizer as jax_make_optimizer
from baddiffusion_tpu_torch.io import state_dict_from_jax
from baddiffusion_tpu_torch.model_configs import NCSNPP_CELEBA_HQ_256
from baddiffusion_tpu_torch.models import (
    AttentionBlock,
    FirDownsample2D,
    FirUpsample2D,
    GroupNorm,
    ResnetBlock2D,
    UNet2DConfig,
    UNet2DModel,
    upfirdn2d,
)
from baddiffusion_tpu_torch.training import create_score_train_state, make_optimizer, make_ve_train_step

# tests/test_unet2d.py's NCSN++-style config: Fourier time, FIR skip blocks, scale_shift, groups from channels
TINY_NCSNPP = dict(
    sample_size=16,
    in_channels=3,
    out_channels=3,
    layers_per_block=1,
    block_out_channels=(32, 64),
    down_block_types=("SkipDownBlock2D", "AttnSkipDownBlock2D"),
    up_block_types=("AttnSkipUpBlock2D", "SkipUpBlock2D"),
    attention_head_dim=16,
    norm_num_groups=None,
    time_embedding_type="fourier",
    resnet_time_scale_shift="scale_shift",
)


@pytest.fixture(autouse=True)
def few_threads():
    """Two threads a BLAS/OpenMP pool: the suite runs several workers at once."""
    with threadpool_limits(limits=2):
        yield


def _nontrivial(params):
    """Norm affines away from 1 and 0, so a scale/bias mix-up cannot pass."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a * 1.1 + 0.05 if path[-1].key in ("scale", "bias") else a, jax.device_get(params))


def _load(module, params):
    module.load_state_dict(state_dict_from_jax(jax.device_get(params)), strict=True)
    return module


def _close(got: torch.Tensor, want, atol: float, rtol: float = 0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol)


# (up, down, pad, kernel): the FIR up and down resamplers' own calls, a
# plain pad, a crop, a 3-tap kernel with both, and an asymmetric kernel (the
# flip) up, with two pads
FIR_CASES = [
    (2, 1, (2, 1), (1, 3, 3, 1)),
    (1, 2, (1, 1), (1, 3, 3, 1)),
    (1, 1, (1, 2), (1, 3, 3, 1)),
    (1, 1, (-1, 0), (1, 3, 3, 1)),
    (2, 2, (1, 1), (1, 2, 1)),
    (2, 1, (1, 0), (1, 2, 4)),
    (2, 1, (1, 1), (1, 2, 4)),
]


@pytest.mark.parametrize("up,down,pad,taps", FIR_CASES)
def test_upfirdn2d_matches_jax(up, down, pad, taps):
    x = np.random.RandomState(0).randn(2, 9, 9, 5).astype(np.float32)
    k = jax_resnet._fir_kernel_2d(taps, gain=float(up * up))
    want = jax_resnet.upfirdn2d(jnp.asarray(x), k, up=up, down=down, pad=pad)
    got = upfirdn2d(torch.from_numpy(x), k, up=up, down=down, pad=pad)
    assert tuple(got.shape) == want.shape
    _close(got, want, atol=1e-6)


def test_fir_weights_made_while_sampling_serve_a_backward_later():
    """The FIR weights are made once a device and dtype; the first made under
    inference mode (a sampling chain) must not be an inference tensor, or a
    later training step's autograd refuses it."""
    x = torch.randn(1, 6, 6, 7)  # a channel count no other test uses: the cache is cold
    with torch.inference_mode():
        FirUpsample2D(7)(x)
        FirDownsample2D(7)(x)
    y = x.clone().requires_grad_()
    (FirUpsample2D(7)(y).sum() + FirDownsample2D(7)(y).sum()).backward()
    assert y.grad is not None and bool(torch.isfinite(y.grad).all())


@pytest.mark.parametrize("use_conv", [False, True])
@pytest.mark.parametrize("direction", ["up", "down"])
def test_fir_resamplers_match_jax(direction, use_conv):
    x = np.random.RandomState(1).randn(2, 8, 8, 4).astype(np.float32)
    jax_cls, port_cls = ((jax_resnet.FirUpsample2D, FirUpsample2D) if direction == "up"
                         else (jax_resnet.FirDownsample2D, FirDownsample2D))
    jm = jax_cls(4, use_conv=use_conv)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"] if use_conv else {}
    want = jm.apply({"params": params}, jnp.asarray(x))
    port = _load(port_cls(4, use_conv=use_conv), params)
    _close(port(torch.from_numpy(x)), want, atol=1e-5)


# ResnetBlock2D resampling: (up, down, kernel, groups_out, use_in_shortcut, time_embedding_norm)
RESNET_CASES = [
    (True, False, None, None, None, "default"),
    (True, False, "fir", 4, True, "default"),
    (True, False, "sde_vp", None, None, "scale_shift"),
    (False, True, None, None, True, "scale_shift"),
    (False, True, "fir", 4, True, "default"),
    (False, True, "sde_vp", 8, None, "default"),
    (False, False, None, None, True, "default"),
]


@pytest.mark.parametrize("up,down,kernel,groups_out,shortcut,norm", RESNET_CASES)
def test_resnet_block_resampling_matches_jax(up, down, kernel, groups_out, shortcut, norm):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    temb = rng.randn(2, 24).astype(np.float32)
    kw = dict(in_channels=16, out_channels=16, temb_channels=24, groups=8, groups_out=groups_out, kernel=kernel,
              use_in_shortcut=shortcut, up=up, down=down, time_embedding_norm=norm, output_scale_factor=2 ** 0.5)
    jm = jax_resnet.ResnetBlock2D(**kw)
    params = _nontrivial(jm.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(temb))["params"])
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(temb))
    port = _load(ResnetBlock2D(**kw), params)
    got = port(torch.from_numpy(x), torch.from_numpy(temb))
    assert tuple(got.shape) == want.shape == (2, 16 if up else 4 if down else 8, 16 if up else 4 if down else 8, 16)
    _close(got, want, atol=1e-5)


def test_temb_free_resnet_block_fuses_norm2_like_jax():
    """No time projection (the VAE's blocks): norm2 takes the fused form even
    under scale_shift, as the JAX block routes it."""
    x = np.random.RandomState(4).randn(2, 4, 4, 16).astype(np.float32)
    kw = dict(in_channels=16, out_channels=32, temb_channels=None, groups=8, time_embedding_norm="scale_shift")
    jm = jax_resnet.ResnetBlock2D(**kw)
    params = _nontrivial(jm.init(jax.random.PRNGKey(5), jnp.asarray(x), None)["params"])
    port = _load(ResnetBlock2D(**kw), params)
    assert port.time_emb_proj is None and port.norm2.silu
    _close(port(torch.from_numpy(x)), jm.apply({"params": params}, jnp.asarray(x), None), atol=1e-5)


def _jax_unet(cfg_kwargs, seed=0):
    """The JAX UNet and its params (init jitted: unjitted, its op-by-op
    dispatch takes three times as long)."""
    model = JaxUNet2DModel(JaxUNet2DConfig(**cfg_kwargs))
    return model, _nontrivial(jax.jit(model.init_params)(jax.random.PRNGKey(seed)))


def _port_unet(cfg_kwargs, params, dtype=torch.float32):
    return _load(UNet2DModel(UNet2DConfig(**cfg_kwargs), device="cpu", dtype=dtype), params)


def test_tiny_ncsnpp_unet_matches_jax():
    """Skip blocks both ways, the skip sample's restart and final add, the
    AttnSkipUp group-count quirk, Fourier time with its division: atol
    1e-4·max|y| (f32 sums in another order over a few layers)."""
    model, params = _jax_unet(TINY_NCSNPP)
    rng = np.random.RandomState(6)
    x = rng.randn(2, 16, 16, 3).astype(np.float32)
    t = np.asarray([0.5, 0.9], np.float32)  # Fourier models take continuous σ
    want = np.asarray(jax.jit(model.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    port = _port_unet(TINY_NCSNPP, params)
    got = port(torch.from_numpy(x), torch.from_numpy(t))
    _close(got, want, atol=1e-4 * np.abs(want).max())
    assert sorted(port.state_dict()) == sorted(flax_to_torch_state_dict(jax.device_get(params)))


def test_bf16_ncsnpp_computes_in_bf16_throughout():
    """As the flax model casts each conv's input to its dtype: the skip
    sample is FIR-filtered in f32 (the input's dtype) but enters the block
    through a bf16 conv, so every block's output stays bf16 (an f32 skip
    conv turned the rest of the UNet f32: 20x slower on the card without
    TF32)."""
    model = UNet2DModel(UNet2DConfig(**TINY_NCSNPP), device="cpu", dtype=torch.bfloat16)
    dtypes = {}

    def record(name):
        def hook(module, args, out):
            dtypes[name] = (out[0] if isinstance(out, tuple) else out).dtype
        return hook

    hooks = [m.register_forward_hook(record(name)) for name, m in model.named_modules()
             if isinstance(m, (ResnetBlock2D, AttentionBlock, torch.nn.Conv2d))]
    x = torch.from_numpy(np.random.RandomState(14).randn(2, 16, 16, 3).astype(np.float32))
    y = model(x, torch.tensor([0.5, 0.9]))
    for h in hooks:
        h.remove()
    assert y.dtype == torch.float32 and bool(torch.isfinite(y).all())
    assert len(dtypes) > 20 and {n for n, d in dtypes.items() if d != torch.bfloat16} == set(), dtypes


CLASS_CASES = {
    "num_class_embeds": dict(num_class_embeds=5),
    "timestep": dict(class_embed_type="timestep"),
    "identity": dict(class_embed_type="identity"),
}
CLASS_BASE = dict(sample_size=8, layers_per_block=1, block_out_channels=(8, 16), norm_num_groups=4,
                  attention_head_dim=8, down_block_types=("DownBlock2D", "AttnDownBlock2D"),
                  up_block_types=("AttnUpBlock2D", "UpBlock2D"))


@pytest.mark.parametrize("kind", sorted(CLASS_CASES))
def test_class_embeddings_match_jax(kind):
    cfg = {**CLASS_BASE, **CLASS_CASES[kind]}
    jm, params = _jax_unet(cfg, seed=7)
    rng = np.random.RandomState(8)
    x = rng.randn(3, 8, 8, 3).astype(np.float32)
    t = np.asarray([3, 400, 999], np.int64)
    if kind == "identity":
        labels = rng.randn(3, 32).astype(np.float32)  # [B, 4·C0], added to the time embedding
    else:
        labels = np.asarray([0, 4, 2] if kind == "num_class_embeds" else [17, 250, 900], np.int64)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(labels)))
    port = _port_unet(cfg, params)
    got = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(labels))
    _close(got, want, atol=1e-4 * np.abs(want).max())
    # the labels move the output
    other = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(labels[::-1].copy()))
    assert not torch.allclose(got, other)


def test_full_width_ncsnpp_has_the_jax_parameter_set_and_kernel_calls():
    """google/ncsnpp-celebahq-256 at full width: the JAX model's keys and
    shapes (on shapes alone), 65,574,549 parameters; per forward 105
    GroupNorm+SiLU calls (K1: two a resnet over 7 + 2 + 7·3 + 6 resnets, one
    skip_norm in each of the 6 upsampling blocks, conv_norm_out) and 4
    attention calls (K3: two in the 16 px down block, the mid block, one in
    the 16 px up block)."""
    jax_cfg = JaxUNet2DConfig(**{f.name: getattr(NCSNPP_CELEBA_HQ_256, f.name)
                                 for f in dataclasses.fields(NCSNPP_CELEBA_HQ_256)})
    shapes = jax.eval_shape(lambda: JaxUNet2DModel(jax_cfg).init_params(jax.random.PRNGKey(0), 256))
    jax_sd = flax_to_torch_state_dict(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes))
    with torch.device("meta"):
        model = UNet2DModel.__new__(UNet2DModel)
        torch.nn.Module.__init__(model)
        model.config = NCSNPP_CELEBA_HQ_256
        model._build(NCSNPP_CELEBA_HQ_256)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {k: v.shape for k, v in jax_sd.items()}
    assert sum(p.numel() for p in model.parameters()) == 65_574_549
    assert sum(isinstance(m, GroupNorm) and m.silu for m in model.modules()) == 105
    assert sum(isinstance(m, AttentionBlock) for m in model.modules()) == 4


def _jax_draws(key, n_sigmas, shape):
    """The draws ``make_ve_train_step`` makes from ``key``, in its order."""
    k_i, k_z = jax.random.split(key)
    idx = jax.random.randint(k_i, (shape[0],), 0, n_sigmas)
    z = jax.random.normal(k_z, shape, jnp.float32)
    return np.array(idx), np.array(z)  # writable copies for torch.from_numpy


LR = 1e-4


@pytest.mark.parametrize("steps", [1, 2])
def test_ve_score_step_matches_jax(steps):
    """The VE DSM step on TINY_NCSNPP in f32, σ and z injected from JAX's
    draws, clip + Adam at a constant lr of 1e-4 (the reference's 256 px
    rate is 8e-5): each step's loss and grad norm rtol 1e-5, and the
    parameters after the last step. Adam's first step is sign-like
    (m̂/√v̂ = g/|g|): a gradient entry within rounding of zero may move by
    anything up to ±lr on either side, and those moves reach step 2's grad
    norm (at lr 1e-3 it missed rtol 1e-5 by 1.5e-5). So every parameter
    within 2·lr a step of JAX's, and all but 1e-3 of them within 1e-6."""
    sigmas = np.asarray(JaxScoreSdeVeScheduler(JaxScoreSdeVeConfig(sigma_max=10.0, num_train_timesteps=50))
                        .create_state().discrete_sigmas)
    model, params = _jax_unet(TINY_NCSNPP, seed=9)
    jax_opt, _ = jax_make_optimizer(LR, schedule="constant")
    jax_state = jax_create_score_train_state(params, jax_opt)
    jax_step = jax_make_ve_train_step(model, jax_opt, sigmas)

    port = _port_unet(TINY_NCSNPP, params)
    opt, _ = make_optimizer(LR, schedule="constant")
    state = create_score_train_state(port, opt)
    step = make_ve_train_step(port, opt, sigmas, device="cpu")

    rng = np.random.RandomState(10)
    for i in range(steps):
        img = (rng.rand(4, 16, 16, 3) * 255).astype(np.uint8)
        key = jax.random.PRNGKey(11 + i)
        jax_state, jm = jax_step(jax_state, jnp.asarray(img), key)
        idx, z = _jax_draws(key, len(sigmas), img.shape)
        state, m = step(state, torch.from_numpy(img), sigma_idx=torch.from_numpy(idx), z=torch.from_numpy(z))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5), i
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5), i
    assert state.step == steps
    want = flax_to_torch_state_dict(jax.device_get(jax_state.params))
    diff = np.concatenate([np.abs(p.detach().numpy() - want[name]).ravel() for name, p in state.params.items()])
    assert diff.max() <= 2 * LR * steps and (diff > 1e-6).mean() <= 1e-3, (diff.max(), (diff > 1e-6).sum())


def test_ve_score_step_draws_from_a_generator_and_trains():
    sigmas = np.exp(np.linspace(np.log(0.01), np.log(10.0), 50)).astype(np.float32)
    port = UNet2DModel(UNet2DConfig(**TINY_NCSNPP), device="cpu", generator=torch.Generator().manual_seed(12))
    opt, _ = make_optimizer(5e-3, num_warmup_steps=2, num_training_steps=100)
    state = create_score_train_state(port, opt)
    assert "time_proj.weight" not in state.params  # the Fourier features are fixed draws
    step = make_ve_train_step(port, opt, sigmas, device="cpu")
    img = (np.random.RandomState(13).rand(4, 16, 16, 3) * 255).astype(np.uint8)
    losses = [float(step(state, img, torch.Generator().manual_seed(0))[1]["loss"]) for _ in range(6)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    with pytest.raises(ValueError, match="generator"):
        step(state, img)
