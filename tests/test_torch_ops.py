"""The port's kernel modules on the CPU: the plain twins of the Hopper kernels
against the JAX package's Pallas kernels (interpret mode) and references, and
the dispatch contract (CPU tensors take the plain version, launch nothing).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from baddiffusion_tpu.ops.attention import attention_reference, fused_attention
from baddiffusion_tpu.ops.groupnorm import fused_groupnorm_silu, groupnorm_silu_reference
from baddiffusion_tpu.models.resnet import GroupNorm as JaxGroupNorm
from baddiffusion_tpu_torch import ops
from baddiffusion_tpu_torch.ops import (
    attention,
    attention_plain,
    groupnorm_plain,
    groupnorm_silu,
    groupnorm_silu_plain,
)

# (B, H, W, C): main-path shapes of the 32 px scratch UNet at batch 2, one
# H = W = 1 and one C = 384 shape among them
GN_SHAPES = [(2, 8, 8, 128), (2, 4, 4, 256), (2, 1, 1, 512), (1, 2, 2, 384), (2, 2, 2, 1024)]
# [B, H, T, D]: the 32 px UNet's calls at batch 2, the scratch UNet at 256 px
# (T = 256, D = 8) and google/ddpm-cifar10-32's (T = 256, D = 256) at batch 1
ATTN_SHAPES = [(2, 64, 4, 8), (2, 64, 1, 8), (1, 2, 256, 64), (1, 4, 256, 8), (1, 1, 256, 256)]


def _gn_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    scale = (rng.rand(shape[-1]) + 0.5).astype(np.float32)
    bias = (rng.randn(shape[-1]) * 0.1).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape", GN_SHAPES)
def test_groupnorm_silu_plain_matches_pallas_kernel(shape):
    x, scale, bias = _gn_inputs(shape, seed=sum(shape))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused_groupnorm_silu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32, 1e-5))
    got = groupnorm_silu_plain(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), 32, 1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("shape", GN_SHAPES)
def test_groupnorm_silu_plain_matches_jax_reference(shape):
    x, scale, bias = _gn_inputs(shape, seed=1 + sum(shape))
    want = np.asarray(groupnorm_silu_reference(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32, 1e-5))
    got = groupnorm_silu_plain(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), 32, 1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_groupnorm_plain_matches_jax_module():
    """The SiLU-free GroupNorm (AttentionBlock's), with a non-default eps and
    an input whose mean is off zero (single-pass variance; a larger offset
    makes f32 cancellation amplify the two libraries' summation orders)."""
    x, scale, bias = _gn_inputs((2, 4, 4, 64), seed=5)
    x = x + 0.5
    want = JaxGroupNorm(num_groups=8, epsilon=1e-6).apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}, jnp.asarray(x)
    )
    got = groupnorm_plain(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), 8, 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attention_plain_matches_pallas_kernel(shape):
    rng = np.random.RandomState(shape[2])
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    scale = 1.0 / np.sqrt(shape[-1])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale))
    got = attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_attention_plain_matches_jax_reference():
    rng = np.random.RandomState(11)
    q, k, v = (rng.randn(2, 4, 16, 8).astype(np.float32) for _ in range(3))
    want = np.asarray(attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.35))
    got = attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 0.35)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_cpu_wrappers_route_to_plain_and_launch_nothing():
    ops.reset_launch_counts()
    x, scale, bias = (torch.from_numpy(a) for a in _gn_inputs((2, 4, 4, 64), seed=3))
    assert torch.equal(groupnorm_silu(x, scale, bias, 32), groupnorm_silu_plain(x, scale, bias, 32))
    q = torch.randn(2, 8, 4, 8, generator=torch.Generator().manual_seed(0))
    assert torch.equal(attention(q, q, q, 0.5), attention_plain(q, q, q, 0.5))
    # the differentiable paths on CPU tensors: plain forward and backward
    x.requires_grad_()
    groupnorm_silu(x, scale, bias, 32).sum().backward()
    q.requires_grad_()
    attention(q, q, q, 0.5).sum().backward()
    assert x.grad is not None and q.grad is not None
    assert ops.launch_counts() == {"groupnorm_silu": 0, "groupnorm_silu_backward": 0, "attention": 0,
                                   "bias_shift": 0, "bias_shift_backward": 0, "vq_nearest": 0}


def test_plain_versions_keep_the_input_dtype():
    x, scale, bias = (torch.from_numpy(a) for a in _gn_inputs((1, 2, 2, 64), seed=4))
    xb = x.to(torch.bfloat16)
    out = groupnorm_silu_plain(xb, scale.to(torch.bfloat16), bias.to(torch.bfloat16), 32)
    assert out.dtype == torch.bfloat16
    ref = groupnorm_silu_plain(xb.float(), scale.to(torch.bfloat16).float(), bias.to(torch.bfloat16).float(), 32)
    torch.testing.assert_close(out.float(), ref, atol=1e-2, rtol=1e-2)
    q = torch.randn(1, 2, 4, 8).to(torch.bfloat16)
    assert attention_plain(q, q, q, 0.5).dtype == torch.bfloat16


# (H, W, C) -> calls per forward of the full-width 32 px scratch UNet
# (block channels 128/128/256/256/512/512, G = 32): its 65 GroupNorm+SiLU calls
MAIN_PATH_GN = {
    (32, 32, 128): 8, (32, 32, 256): 3, (16, 16, 128): 7, (16, 16, 256): 2, (16, 16, 384): 1,
    (8, 8, 128): 1, (8, 8, 256): 6, (8, 8, 384): 1, (8, 8, 512): 2, (4, 4, 256): 7, (4, 4, 512): 2,
    (4, 4, 768): 1, (2, 2, 256): 1, (2, 2, 512): 6, (2, 2, 768): 1, (2, 2, 1024): 2, (1, 1, 512): 11,
    (1, 1, 1024): 3,
}
# (B, H, W, C, G, element bytes, alignment): the main path at the sampling
# (16) and training (128) batches in bf16 and f32, then the envelope: slabs
# too large to stage (128 px, 256 px), one that stages only at its
# narrowest (64 px), group widths 1, 3 and 12, G = 1, misaligned storage,
# H·W <= 16 with C = 1024 at a batch large enough for whole rows, a channel
# count with no sector-multiple slab but the row
PLAN_CASES = [(b, h, w, c, 32, eb, 16) for (h, w, c) in MAIN_PATH_GN for b in (16, 128) for eb in (2, 4)] + [
    (1, 128, 128, 128, 32, 2, 16), (1, 128, 128, 128, 32, 4, 16), (2, 256, 256, 128, 32, 2, 16),
    (1, 64, 64, 128, 32, 2, 16), (2, 5, 7, 32, 32, 2, 16), (2, 3, 3, 96, 32, 2, 16), (2, 16, 16, 384, 32, 4, 16),
    (2, 8, 8, 32, 1, 4, 16), (2, 4, 4, 256, 32, 2, 2), (2, 4, 4, 256, 32, 4, 4), (192, 2, 2, 1024, 32, 2, 16),
    (2, 4, 4, 24, 8, 2, 16),
]


@pytest.mark.parametrize("b,h,w,c,groups,elem_bytes,align", PLAN_CASES)
def test_groupnorm_silu_launch_plan(b, h, w, c, groups, elem_bytes, align):
    """K1's launch plan (computed on the CPU; the kernel checks it again):
    whole groups, a whole number of 32-byte sectors per pixel or the whole
    row, a pack that divides the slab and the pointers' alignment, shared
    memory within the H100's 227 KB, x walked twice only where no slab can
    be staged, and a block per SM wherever 32-byte slabs allow it."""
    plan = ops.groupnorm_silu_plan(b, h * w, c, groups, elem_bytes, align)
    _check_plan(plan, b, h * w, c, groups, elem_bytes, align, staged_tensors=1)


@pytest.mark.parametrize("b,h,w,c,groups,elem_bytes,align", PLAN_CASES)
def test_groupnorm_silu_backward_launch_plan(b, h, w, c, groups, elem_bytes, align):
    """K2's launch plan, held to K1's rules with two tensors staged (x and
    the cotangent): a staged plan holds both slabs in shared memory, and
    they are walked twice only where no slab of both can be staged."""
    plan = ops.groupnorm_silu_backward_plan(b, h * w, c, groups, elem_bytes, align)
    _check_plan(plan, b, h * w, c, groups, elem_bytes, align, staged_tensors=2)


def _check_plan(plan, b, hw, c, groups, elem_bytes, align, staged_tensors):
    cg = c // groups
    slab_c = plan.slab_groups * cg
    assert groups % plan.slab_groups == 0 and plan.blocks == b * groups // plan.slab_groups
    assert (slab_c * elem_bytes) % 32 == 0 or plan.slab_groups == groups
    assert slab_c % plan.vec == 0 and align % (plan.vec * elem_bytes) == 0 and plan.vec * elem_bytes <= 16
    cols = slab_c // plan.vec
    assert plan.threads % cols == 0 and plan.threads <= 512
    assert plan.smem_bytes <= 227 * 1024
    # the narrowest slab the rules allow, and the least shared memory its staging takes
    narrowest = min(k for k in range(1, groups + 1)
                    if groups % k == 0 and ((k * cg * elem_bytes) % 32 == 0 or k == groups))
    if plan.variant == "staged":
        assert plan.smem_bytes >= staged_tensors * hw * slab_c * elem_bytes
    else:
        assert plan.variant == "two_walk"
        assert staged_tensors * hw * narrowest * cg * elem_bytes + 8 * narrowest * cg > 227 * 1024
    if b * groups // narrowest >= 132:
        assert plan.blocks >= 132


def test_groupnorm_silu_launch_plan_refuses_too_wide_a_group():
    with pytest.raises(ValueError, match="at most 512 packs"):
        ops.groupnorm_silu_plan(1, 1, 8192, 1, 2, 2)


def test_groupnorm_silu_backward_launch_plan_refuses_what_the_forward_refuses():
    """K2 takes every group K1 takes (up to 512 packs) and refuses the rest
    with K1's message."""
    assert ops.groupnorm_silu_backward_plan(1, 4, 4096, 1, 2, 16).vec == 8
    with pytest.raises(ValueError, match="at most 512 packs"):
        ops.groupnorm_silu_backward_plan(1, 1, 8192, 1, 2, 2)


def test_groupnorm_rejects_indivisible_channels():
    with pytest.raises(ValueError, match="not divisible"):
        groupnorm_silu(torch.zeros(1, 2, 2, 48), torch.ones(48), torch.zeros(48), 32)


# [B, H, T, D] -> K3's variant in bf16 (f32 takes packed where bf16 does,
# tf32x3_wg where D <= 64 and T > 16, else tf32x3): the main path at the training (128)
# and sampling (16) batches; the scratch UNet at 256 px, micro-batch 4;
# google/ddpm-cifar10-32 at batch 16; google/ddpm-ema-celebahq-256's 512-wide
# head; the envelope's long end; ragged T; one head of 8 tokens of 40
ATTN_PLAN_CASES = [
    ((128, 64, 4, 8), "packed"), ((128, 64, 1, 8), "packed"), ((16, 64, 4, 8), "packed"), ((16, 64, 1, 8), "packed"),
    ((4, 64, 256, 8), "tiled"), ((4, 64, 64, 8), "tiled"), ((16, 1, 256, 256), "tiled"), ((16, 1, 16, 256), "tiled"),
    ((2, 1, 256, 512), "wide"), ((4, 8, 1024, 64), "tiled"), ((1, 1, 1024, 512), "wide"),
    ((2, 3, 100, 64), "tiled"), ((1, 1, 8, 40), "tiled"), ((2, 3, 40, 16), "tiled"), ((1, 2, 33, 16), "tiled"),
    # the VQ-VAE's mid block at LDM-CELEBA-HQ-256's 64x64 latent (the envelope's long end), the LDM UNet's
    # three attention resolutions at the sampling batch, NCSN++ 256 px at 16x16 and 4x4, and T = 4096 at
    # every tiled depth
    ((16, 1, 4096, 512), "wide"), ((16, 14, 1024, 32), "tiled"), ((16, 21, 256, 32), "tiled"),
    ((16, 28, 64, 32), "tiled"), ((2, 32, 256, 8), "tiled"), ((2, 32, 16, 8), "packed"), ((1, 2, 4096, 8), "tiled"),
    ((1, 1, 4096, 64), "tiled"), ((1, 1, 4096, 256), "tiled"), ((1, 1, 4093, 136), "tiled"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape,bf16_variant", ATTN_PLAN_CASES)
def test_attention_launch_plan(shape, bf16_variant, dtype):
    """K3's launch plan (computed on the CPU; the kernel checks it again):
    packed for T <= 16 and D <= 32 in both dtypes, tiled for the rest of bf16
    up to D = 256, wide for bf16 above it, tf32x3_wg for f32 with D <= 64 and
    T > 16, tf32x3 for the rest of f32; every query row covered, shared
    memory within the H100's 227 KB, and, for packed, a block per SM
    wherever the rows allow it. Tiled blocks stage their head's whole K and
    V, so they keep their full height (64 rows) whatever the grid: on the
    H100 that was faster than shorter blocks at every shape timed. tf32x3
    and wide split D between the warps of a 16-row group: ``depth`` /
    (``threads`` / (2 ``rows``)) columns a warp. tf32x3_wg: persistent
    blocks, one an SM or one an item (two heads where T <= 64, else 128
    query rows), of 384 threads (a feeding warpgroup and two consumers of
    64 rows), 64 keys a staged tile, D padded to 32 or 64, its ring of
    stages and Q's buffers in shared memory."""
    b, h, t, d = shape
    plan = ops.attention_plan(b * h, t, d, dtype)
    f32_variant = "tf32x3_wg" if d <= 64 and t > 16 else "tf32x3"
    want = bf16_variant if dtype == torch.bfloat16 or bf16_variant == "packed" else f32_variant
    assert plan.variant == want
    assert plan.smem_bytes <= 227 * 1024
    assert (plan.stages != 0) == (plan.variant == "tf32x3_wg")
    if plan.variant == "tf32x3_wg":
        depth = 32 if d <= 32 else 64
        stages = {32: 4, 64: 2}[depth]
        assert (plan.threads, plan.rows, plan.key_tile, plan.depth, plan.stages) == (384, 64, 64, depth, stages)
        tile = 64 * 128  # a [64][32] f32 tile
        q_tiles = {32: 2, 64: 2 * 2 * 2}[depth]  # both consumers' Q; at depth 64 in two halves, and its lo
        tiles = q_tiles + 5 * (depth // 32) * stages  # 5 tiles a stage
        assert plan.smem_bytes == tile * tiles + 8 * (3 * stages + 2) + 1024
        items = -(-b * h // 2) if t <= 64 else b * h * -(-t // 128)
        assert plan.blocks == min(items, 132)
        # the consumers' 64-row tiles cover every row: an item's two warpgroups take 128 rows or two heads
        assert 2 * plan.rows * -(-t // (2 * plan.rows)) >= t and 2 * plan.rows == 128
        finest = 0
    elif plan.variant == "packed":
        assert plan.rows == plan.threads and plan.threads in (32, 64, 128, 256) and plan.smem_bytes == 0
        assert plan.blocks == -(-b * h * t // plan.threads)
        finest = -(-b * h * t // 32)
    elif plan.variant == "tiled":
        assert plan.threads == 128 and plan.rows == 64
        assert plan.depth == min(p for p in (16, 32, 64, 128, 256) if p >= d)  # D zero-padded to an instantiation
        assert plan.blocks == b * h * -(-t // plan.rows)
        assert plan.smem_bytes >= (plan.rows + 4 * plan.key_tile) * plan.depth * 2
        finest = 0
    else:
        parts = plan.threads // (2 * plan.rows)
        part_depth = plan.depth // parts
        assert plan.threads == 2 * plan.rows * parts and plan.rows in (16, 32, 64)
        assert part_depth in ((8, 16, 32, 64, 128) if dtype == torch.float32 else (128, 256))
        assert parts == -(-d // part_depth)  # no warp owns only padding
        assert plan.threads <= (512 if part_depth == (64 if dtype == torch.float32 else 128) else 256)
        assert plan.rows // 2 < t or plan.rows == 16  # no taller than T needs
        elem = 4 if dtype == torch.float32 else 2
        staged = (plan.rows + 4 * plan.key_tile) * plan.depth * elem + (4 * plan.rows * parts * plan.key_tile if parts > 1 else 0)
        assert plan.smem_bytes >= staged
        assert plan.blocks == b * h * -(-t // plan.rows)
        finest = 0
    if finest >= 132:
        assert plan.blocks >= 132
    assert ops.attention_plan(b * h, t, d, dtype) is plan  # cached


def test_attention_plan_runs_every_longer_bf16_call_on_the_tensor_cores():
    """Every bf16 call with 16 < T and D <= 256 takes the tiled plan with
    64-row blocks, and every call with T <= 16 and D <= 32 the packed one,
    in both dtypes."""
    for t in list(range(17, 1025)) + list(range(1025, 4097, 61)) + [4096]:
        for d in ((8, 64, 256) if t % 97 else range(8, 264, 8)):
            plan = ops.attention_plan(3, t, d, torch.bfloat16)
            assert plan.variant == "tiled" and plan.rows == 64, (t, d, plan)
    for t in range(1, 17):
        for d in (8, 16, 24, 32):
            for dtype in (torch.float32, torch.bfloat16):
                assert ops.attention_plan(5, t, d, dtype).variant == "packed", (t, d, dtype)


def test_attention_plan_runs_no_call_on_the_old_rowwise_kernel():
    """Over the envelope (T in [1, 4096], D in [8, 512], both dtypes): no plan
    is rowwise; every f32 call outside packed takes tf32x3_wg where D <= 64
    and T > 16, else tf32x3, every bf16 call
    with D > 256 takes wide; shared memory stays within 227 KB and threads
    within the variant's cap."""
    ts = list(range(1, 80)) + list(range(80, 4097, 37)) + [255, 256, 257, 1023, 1024, 4095, 4096]
    for bh in (1, 16, 2048):
        for t in ts:
            for d in range(8, 520, 8):
                for dtype in (torch.float32, torch.bfloat16):
                    plan = ops.attention_plan(bh, t, d, dtype)
                    assert plan.variant != "rowwise"
                    if t <= 16 and d <= 32:
                        assert plan.variant == "packed", (bh, t, d, dtype, plan)
                    elif dtype == torch.float32:
                        assert plan.variant == ("tf32x3_wg" if d <= 64 and t > 16 else "tf32x3"), (bh, t, d, plan)
                    elif d > 256:
                        assert plan.variant == "wide", (bh, t, d, plan)
                    else:
                        assert plan.variant == "tiled", (bh, t, d, plan)
                    assert plan.smem_bytes <= 227 * 1024 and plan.threads <= 512, (bh, t, d, dtype, plan)
                    if plan.variant in ("tf32x3", "wide"):
                        assert plan.threads % (plan.depth // (4 if dtype == torch.float32 else 8)) == 0
        ops.attention_plan.cache_clear()
    assert "rowwise" not in importlib.import_module("baddiffusion_tpu_torch.ops.attention").VARIANTS


def test_attention_variant_counts_start_at_zero_and_reset():
    """``ops.attention_variant_counts()`` holds every plan variant and is
    zeroed by ``ops.reset_launch_counts()``; a CPU call runs the plain twin
    and counts nothing; ``ops.launch_counts()`` keeps its kernel names."""
    ops.reset_launch_counts()
    counts = ops.attention_variant_counts()
    assert counts == dict.fromkeys(("packed", "tiled", "tf32x3", "wide", "tf32x3_wg"), 0)
    q = torch.zeros(1, 1, 32, 32)
    ops.attention(q, q, q, 1.0)
    assert ops.attention_variant_counts() == counts
    assert set(ops.launch_counts()) == {"groupnorm_silu", "groupnorm_silu_backward", "attention", "bias_shift",
                                        "bias_shift_backward", "vq_nearest"}


def test_attention_plan_refuses_outside_the_envelope():
    for t, d in ((4097, 8), (4097, 512), (0, 8), (4, 4), (4, 12), (4, 520)):
        with pytest.raises(ValueError, match="envelope"):
            ops.attention_plan(1, t, d, torch.bfloat16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.attention_plan(1, 4, 8, torch.float16)
