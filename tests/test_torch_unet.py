"""The port's UNet against the JAX package's on the CPU: weight conversion,
forward parity on the same weights and inputs, and the channels_last layout
the GroupNorm kernel needs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baddiffusion_tpu.io.hf import flax_to_torch_state_dict, torch_to_flax_params
from baddiffusion_tpu.models import UNet2DConfig as JaxUNet2DConfig
from baddiffusion_tpu.models import UNet2DModel as JaxUNet2DModel
from baddiffusion_tpu.models.unet2d import DEFAULT_SCRATCH_CONFIG as JAX_SCRATCH
from baddiffusion_tpu_torch import ops
from baddiffusion_tpu_torch.io import state_dict_from_jax
from baddiffusion_tpu_torch.models import DEFAULT_SCRATCH_CONFIG, GroupNorm, UNet2DConfig, UNet2DModel

TINY = dict(
    sample_size=16,
    in_channels=3,
    out_channels=3,
    layers_per_block=2,
    block_out_channels=(32, 64),
    down_block_types=("DownBlock2D", "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "UpBlock2D"),
    norm_num_groups=8,
    attention_head_dim=8,
)
VARIANTS = {
    "default": {},
    "scale_shift": {"resnet_time_scale_shift": "scale_shift"},
    # the google/ddpm-* family: sin-first embedding, freq_shift 1, asymmetric
    # downsample pad, one attention head
    "ddpm": {"flip_sin_to_cos": False, "freq_shift": 1, "downsample_padding": 0, "attention_head_dim": None},
}


def _jax_model(variant, seed=0):
    cfg = JaxUNet2DConfig(**{**TINY, **VARIANTS[variant]})
    model = JaxUNet2DModel(cfg)
    params = model.init_params(jax.random.PRNGKey(seed))
    # make norm affines non-trivial so a scale/bias mix-up cannot pass
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a * 1.1 + 0.05 if path[-1].key in ("scale", "bias") else a, params
    )
    return cfg, model, params


def _port_model(cfg_kwargs, params):
    model = UNet2DModel(UNet2DConfig(**cfg_kwargs), device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.device_get(params)), strict=True)
    return model


def test_state_dict_from_jax_equals_flax_to_torch_and_loads_strict():
    _, _, params = _jax_model("default")
    params = jax.device_get(params)
    ours = state_dict_from_jax(params)
    theirs = flax_to_torch_state_dict(params)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    model = UNet2DModel(UNet2DConfig(**TINY), device="cpu")
    assert sorted(model.state_dict()) == sorted(ours)
    model.load_state_dict(ours, strict=True)


def test_scratch_config_has_the_jax_parameter_set():
    """Full-width scratch UNet: same keys and shapes as the JAX package's
    (113,673,219 parameters), checked on shapes alone."""
    shapes = jax.eval_shape(lambda: JaxUNet2DModel(JAX_SCRATCH).init_params(jax.random.PRNGKey(0), 32))
    jax_sd = flax_to_torch_state_dict(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes))
    model = UNet2DModel(DEFAULT_SCRATCH_CONFIG, device="cpu")
    ours = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert ours == {k: v.shape for k, v in jax_sd.items()}
    assert sum(p.numel() for p in model.parameters()) == 113_673_219


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_tiny_forward_matches_jax(variant):
    cfg, jmodel, params = _jax_model(variant, seed=1)
    rng = np.random.RandomState(2)
    x = rng.randn(2, 16, 16, 3).astype(np.float32)
    t = np.array([3, 777], np.int32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    model = _port_model({**TINY, **VARIANTS[variant]}, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_scratch_forward_matches_jax_at_32px():
    """The full-width scratch UNet (113.7M parameters), batch 1, f32. The
    port's seeded weights go to JAX through the JAX package's own converter,
    which spares a JAX init compile."""
    model = UNet2DModel(DEFAULT_SCRATCH_CONFIG, device="cpu", generator=torch.Generator().manual_seed(4))
    params = torch_to_flax_params({k: v.numpy() for k, v in model.state_dict().items()})
    rng = np.random.RandomState(5)
    x = rng.randn(1, 32, 32, 3).astype(np.float32)
    t = np.array([421], np.int32)
    want = np.asarray(jax.jit(JaxUNet2DModel(JAX_SCRATCH).apply)({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_every_groupnorm_input_is_channels_last(variant):
    """The GroupNorm kernel takes NHWC-contiguous memory only (NCHW in
    channels_last) and raises otherwise: every norm input on the forward,
    through the skip concatenations, upsampling and padding, must arrive so."""
    cfg = DEFAULT_SCRATCH_CONFIG if variant == "default" else UNet2DConfig(**{**TINY, **VARIANTS[variant]})
    model = UNet2DModel(cfg, device="cpu")
    seen = []

    def check(module, args):
        (x,) = args
        seen.append(x.shape)
        assert x.is_contiguous(), f"NHWC input of shape {tuple(x.shape)} is not contiguous"
        assert x.permute(0, 3, 1, 2).is_contiguous(memory_format=torch.channels_last)

    for m in model.modules():
        if isinstance(m, GroupNorm):
            m.register_forward_pre_hook(check)
    size = 32 if variant == "default" else 16
    with torch.no_grad():
        model(torch.zeros(2, size, size, 3), torch.tensor([10, 20]))
    n_norms = sum(isinstance(m, GroupNorm) for m in model.modules())
    assert len(seen) == n_norms
    if variant == "default":  # 65 fused GroupNorm+SiLU and 6 plain (attention) norms
        assert sum(m.silu for m in model.modules() if isinstance(m, GroupNorm)) == 65
        assert n_norms == 71


def test_conv_weights_are_channels_last():
    model = UNet2DModel(UNet2DConfig(**TINY), device="cpu")
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    assert convs and all(c.weight.is_contiguous(memory_format=torch.channels_last) for c in convs)


def test_seeded_init_is_deterministic_and_device_independent_of_global_rng():
    torch.manual_seed(123)
    a = UNet2DModel(UNet2DConfig(**TINY), device="cpu", generator=torch.Generator().manual_seed(9))
    torch.manual_seed(456)
    b = UNet2DModel(UNet2DConfig(**TINY), device="cpu", generator=torch.Generator().manual_seed(9))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka


def test_config_json_round_trips_with_the_jax_package(tmp_path):
    cfg = UNet2DConfig(**{**TINY, **VARIANTS["ddpm"]})
    cfg.save(str(tmp_path / "port"))
    assert dataclasses.asdict(JaxUNet2DConfig.load(str(tmp_path / "port"))) == dataclasses.asdict(cfg)
    JaxUNet2DConfig(**TINY).save(str(tmp_path / "jax"))
    assert UNet2DConfig.load(str(tmp_path / "jax")) == UNet2DConfig(**TINY)


@pytest.mark.parametrize("flip,shift", [(True, 0), (False, 1)])
def test_timestep_embedding_matches_jax(flip, shift):
    from baddiffusion_tpu.models.embeddings import get_timestep_embedding as jax_embedding
    from baddiffusion_tpu_torch.models import get_timestep_embedding

    t = np.array([0, 1, 487, 999], np.int32)
    want = np.asarray(jax_embedding(jnp.asarray(t), 129, flip_sin_to_cos=flip, downscale_freq_shift=shift))
    got = get_timestep_embedding(torch.from_numpy(t), 129, flip_sin_to_cos=flip, downscale_freq_shift=shift)
    # sin/cos of f32 arguments up to ~1000 rad: one ulp of the argument is ~6e-5
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_fourier_projection_matches_jax():
    from baddiffusion_tpu.models.embeddings import GaussianFourierProjection as JaxFourier
    from baddiffusion_tpu_torch.models import GaussianFourierProjection

    weight = np.random.RandomState(3).randn(16).astype(np.float32) * 16
    sigmas = np.array([0.01, 1.0, 50.0], np.float32)
    want = JaxFourier(embedding_size=16, scale=16.0).apply({"params": {"weight": jnp.asarray(weight)}}, jnp.asarray(sigmas))
    proj = GaussianFourierProjection(embedding_size=16, scale=16.0)
    with torch.no_grad():
        proj.weight.copy_(torch.from_numpy(weight))
    np.testing.assert_allclose(proj(torch.from_numpy(sigmas)).numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("use_safetensors", [True, False], ids=["safetensors", "bin"])
def test_saved_unet_loads_in_the_jax_package(tmp_path, use_safetensors):
    from baddiffusion_tpu.io import load_unet as jax_load_unet
    from baddiffusion_tpu_torch.io import load_unet, save_unet

    model = UNet2DModel(UNet2DConfig(**TINY), device="cpu", generator=torch.Generator().manual_seed(3))
    save_unet(model, str(tmp_path), use_safetensors=use_safetensors)
    _, params = jax_load_unet(str(tmp_path))
    for k, v in flax_to_torch_state_dict(params).items():
        np.testing.assert_array_equal(v, model.state_dict()[k].numpy(), err_msg=k)
    again = load_unet(str(tmp_path), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again.state_dict().values(), model.state_dict().values()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_groupnorm_keeps_an_f32_affine_as_the_jax_model(seed):
    """Under a bf16 compute dtype the JAX model keeps GroupNorm's γ/β in f32
    and applies the affine in f32 before the one rounding to bf16; the port
    once cast γ/β to bf16 with the rest of the weights. One GroupNorm+SiLU
    layer on bf16 input, γ/β not representable in bf16, against the JAX
    ``GroupNormSiLU``: with f32 γ/β at most 0.2% of the outputs differ, each
    by at most one bf16 rounding (2⁻⁷ relative; the statistics are f32 sums
    in another order), where bf16 γ/β (the old path, rebuilt here by casting
    the module) move about 30% of them (measured 30.0%, 31.5%, 30.2% for
    seeds 0-2, against 0%, 0.01%, 0.05% with f32 γ/β)."""
    from baddiffusion_tpu.models.resnet import GroupNormSiLU as JaxGroupNormSiLU

    rng = np.random.RandomState(seed)
    c, groups = 64, 8
    scale = (1 + 0.3 * rng.randn(c)).astype(np.float32)
    bias = (0.3 * rng.randn(c)).astype(np.float32)
    x = np.array(jnp.asarray(rng.randn(2, 8, 8, c) * 2 + 0.5, jnp.bfloat16).astype(jnp.float32))
    jparams = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    want = np.asarray(JaxGroupNormSiLU(groups, 1e-5).apply(jparams, jnp.asarray(x, jnp.bfloat16)), np.float32)
    frac = {}
    for affine in (torch.float32, torch.bfloat16):
        norm = GroupNorm(groups, c, 1e-5, silu=True)
        with torch.no_grad():
            norm.weight.copy_(torch.from_numpy(scale))
            norm.bias.copy_(torch.from_numpy(bias))
            got = norm.to(affine)(torch.from_numpy(x).to(torch.bfloat16))
        assert got.dtype == torch.bfloat16
        d = np.abs(got.float().numpy() - want)
        frac[affine] = (d > 0).mean()
        if affine == torch.float32:
            assert np.all(d <= 2.0**-7 * np.abs(want) + 1e-6), d.max()
    assert frac[torch.float32] <= 2e-3 and frac[torch.bfloat16] >= 0.2, frac


def _bf16_ulps(got, want):
    """|got − want| in units of the bf16 spacing at |got| (8 significant bits)."""
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(got), 2.0**-100))) - 7)
    return np.abs(got - want) / ulp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_default_jax_groupnorm_silu_rounds_twice_where_the_port_rounds_once(seed):
    """The gap between the JAX model's default bf16 GroupNorm → SiLU (the
    norm rounds to bf16, then SiLU runs on the bf16 value: ``gn_silu``
    without ``BADDIFFUSION_FUSE_GN``, which ``bench.py`` and the trainer run)
    and the port's fused form (SiLU in f32, one rounding). Measured on seeds
    0-5: 44.8-46.3% of the outputs differ, 2.0-2.5% of them by more than one
    bf16 step, none by more than 6 steps, the largest by 0.54-0.72% of
    max |y|. Bounds: 35-55% differ, at most 5% by more than one step, none
    by more than 8, none by more than 1% of max |y|."""
    from baddiffusion_tpu.models.resnet import GroupNorm as JaxGroupNorm

    rng = np.random.RandomState(seed)
    c, groups = 64, 8
    scale = (1 + 0.3 * rng.randn(c)).astype(np.float32)
    bias = (0.3 * rng.randn(c)).astype(np.float32)
    x = np.array(jnp.asarray(rng.randn(2, 8, 8, c) * 2 + 0.5, jnp.bfloat16).astype(jnp.float32))
    jparams = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    want = jax.nn.silu(JaxGroupNorm(groups, 1e-5).apply(jparams, jnp.asarray(x, jnp.bfloat16)))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want, np.float32)
    norm = GroupNorm(groups, c, 1e-5, silu=True)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
        got = norm(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    ulps = _bf16_ulps(got, want)
    assert 0.35 <= (ulps > 0).mean() <= 0.55, (ulps > 0).mean()
    assert (ulps > 1).mean() <= 0.05 and ulps.max() <= 8, ((ulps > 1).mean(), ulps.max())
    assert np.abs(got - want).max() <= 0.01 * np.abs(want).max()


@pytest.mark.parametrize("shape", [(2, 64, 4, 8), (2, 64, 1, 8), (2, 4, 64, 32), (1, 2, 255, 64)])
def test_bf16_jax_attention_rounds_its_probabilities_where_the_port_keeps_f32(shape):
    """The gap between the JAX model's bf16 attention at T < 256
    (``attention_reference``: f32 softmax, probabilities rounded to bf16
    before the product with V) and the port's (probabilities and the product
    in f32, one rounding of the output), on the same bf16 q, k, v. Measured
    on seeds 0-5: at T = 1 (p = 1) nothing differs; at T = 4, 64 and 255,
    35-42% of the outputs differ, the largest by 0.28-0.76% of max |y|.
    Bounds: 30-50% differ, none by more than 1% of max |y|. With the
    probabilities kept in f32 on the JAX side too, the gap closes to what
    sums in another order leave (measured: at most 0.034% of the outputs,
    by at most 0.11% of max |y|; bounds 0.1% and 0.2%)."""
    from baddiffusion_tpu.ops.attention import attention_reference

    rng = np.random.RandomState(0)
    q, k, v = (np.array(jnp.asarray(rng.randn(*shape), jnp.bfloat16).astype(jnp.float32)) for _ in range(3))
    scale = shape[-1] ** -0.5
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(attention_reference(qj, kj, vj, scale), np.float32)
    probs = jax.nn.softmax(jnp.einsum("bhqd,bhkd->bhqk", qj, kj, preferred_element_type=jnp.float32) * scale, -1)
    want_f32_probs = np.asarray(jnp.einsum("bhqk,bhkd->bhqd", probs, vj.astype(jnp.float32)).astype(jnp.bfloat16),
                                np.float32)
    got = ops.attention_plain(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), scale).float().numpy()
    d_f32_probs = np.abs(got - want_f32_probs)
    assert (d_f32_probs > 0).mean() <= 1e-3 and d_f32_probs.max() <= 2e-3 * np.abs(want).max()
    d = np.abs(got - want)
    if shape[2] == 1:
        assert not d.any()
    else:
        assert 0.30 <= (d > 0).mean() <= 0.50, (d > 0).mean()
    assert d.max() <= 0.01 * np.abs(want).max()


def test_bf16_compute_forward_matches_the_jax_bf16_model(monkeypatch):
    """The whole bf16 forward: the port's ``compute_copy(torch.bfloat16)``
    (f32 GroupNorm affines) against the JAX ``UNet2DModel(cfg,
    dtype=jnp.bfloat16)`` on the same f32 parameters, with γ/β off 1 and 0.
    The JAX side takes its fused GroupNorm+SiLU form (SiLU in f32, then one
    rounding, as the port's kernel), here its jnp reference. The two round to
    bf16 at every layer but sum in other orders: measured max error 0.049
    of max |y| 4.16 (0.059 of 3.86 with the next seeds); tolerance 3% of
    max |y|."""
    monkeypatch.setenv("BADDIFFUSION_FUSE_GN", "1")
    cfg, _, params = _jax_model("default", seed=0)
    rng = np.random.RandomState(10)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a * (1 + 0.3 * rng.randn(*a.shape).astype(np.float32)) if path[-1].key == "scale" else a,
        params,
    )
    x = rng.randn(4, 16, 16, 3).astype(np.float32)
    t = np.array([3, 777, 50, 500], np.int32)
    want = np.asarray(JaxUNet2DModel(cfg, dtype=jnp.bfloat16).apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    model = _port_model(TINY, params).compute_copy(torch.bfloat16)
    assert all(m.weight.dtype == torch.float32 for m in model.modules() if isinstance(m, GroupNorm))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, atol=0.03 * np.abs(want).max())
