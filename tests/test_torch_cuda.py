"""The port's CUDA kernels on the card, beyond the main path's shapes: every
pack width and lane layout, misaligned and partial-tile inputs, each launch
plan, the wrappers' refusals, the GroupNorm+SiLU backward (K2) and its
bitwise-repeatable dx, dγ and dβ, the conv bias-shift pair (in place, at the
cells' shapes, bitwise-repeatable gradients, in a CUDA graph, a launch a conv
of the published UNets), the VQ quantizer's nearest-code kernel (ragged
shapes, exact ties, the LDM measure's N and K without a distance matrix),
K1 and the bias shift on a tensor of over 2**31 elements, a small UNet on the card against the
CPU's plain path (forward, one train step, two steps of ``train_loop``, a
DPM-Solver++ chain), ``device_prefetch``'s side-stream copies, each
scheduler of the zoo with a stand-in denoiser on the card against the CPU,
segment mode's CUDA graphs (bitwise the eager chain, with two generators, the
callers' generator states, weights updated in place, the bounded cache), and
the scale-out path on one card: the train step through a world of one
rank over NCCL bitwise equal to the plain step, and two ranks sharing the
card over gloo (this file run as their script) equal to one rank.

These tests need an NVIDIA GPU and skip without one. Run them on the card
without the JAX-side conftest (this file imports no JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from baddiffusion_tpu_torch import factory, ops
from baddiffusion_tpu_torch.models import UNet2DConfig, UNet2DModel
from baddiffusion_tpu_torch.pipelines import sample_chain
from baddiffusion_tpu_torch.schedulers import KarrasVeScheduler

pytestmark = pytest.mark.cuda
TOL = {torch.float32: dict(atol=1e-5, rtol=0.0), torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gn_args(shape, dtype, dev, seed=0):
    """x in ``dtype``; γ/β f32 whatever x's dtype, as the kernels take them."""
    g = torch.Generator(dev).manual_seed(seed)
    c = shape[-1]
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    w = torch.rand(c, generator=g, device=dev) + 0.5
    b = 0.1 * torch.randn(c, generator=g, device=dev)
    return x, w, b


# (shape, groups): group widths 1, 2, 3, 8, 32 (every pack width), G = 1, and
# a group of 256 channels; then K1's launch plans: the staged slab at
# the sampling and training batches, the two-walk slab too large to stage,
# H·W <= 16 with C = 1024, and group width 12
GN_CASES = [((2, 5, 7, 32), 32), ((3, 5, 7, 64), 32), ((2, 3, 3, 96), 32), ((2, 4, 4, 64), 8), ((2, 8, 8, 32), 1),
            ((2, 3, 3, 512), 2), ((16, 32, 32, 128), 32), ((128, 32, 32, 128), 32), ((1, 128, 128, 128), 32),
            ((16, 4, 4, 1024), 32), ((2, 16, 16, 384), 32)]
# (shape, groups, the plan's variant, whether its slab is the whole row)
K1_PLAN_CASES = [((16, 32, 32, 128), 32, "staged", False), ((128, 16, 16, 256), 32, "staged", False),
                 ((1, 128, 128, 128), 32, "two_walk", False), ((16, 4, 4, 1024), 32, "staged", False),
                 ((192, 2, 2, 1024), 32, "staged", True), ((2, 4, 4, 24), 8, "staged", True),
                 ((2, 5, 7, 32), 32, "staged", False), ((2, 16, 16, 384), 32, "staged", False)]
# K2's: the staged slab at the training batch, the two-walk slab, the whole
# row at H·W <= 16, group widths 1, 3 and 12, and one group of 512 channels
K2_PLAN_CASES = [((128, 32, 32, 128), 32, "staged", False), ((128, 16, 16, 256), 32, "staged", False),
                 ((1, 128, 128, 128), 32, "two_walk", False), ((192, 2, 2, 1024), 32, "staged", True),
                 ((2, 5, 7, 32), 32, "staged", False), ((2, 3, 3, 96), 32, "staged", False),
                 ((2, 16, 16, 384), 32, "staged", False), ((2, 2, 2, 512), 1, "staged", True)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,groups", GN_CASES)
def test_groupnorm_silu_kernel_matches_plain(dev, shape, groups, dtype):
    x, w, b = _gn_args(shape, dtype, dev)
    got = ops.groupnorm_silu(x, w, b, groups, 1e-6)
    torch.testing.assert_close(got.float(), ops.groupnorm_silu_plain(x, w, b, groups, 1e-6).float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_groupnorm_silu_kernel_takes_misaligned_storage(dev, dtype):
    """A contiguous view one element into its storage: the kernel narrows
    its pack width to the pointers' alignment."""
    x, w, b = _gn_args((2, 4, 4, 256), dtype, dev)
    shifted = torch.empty(x.numel() + 1, dtype=dtype, device=dev)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    torch.testing.assert_close(ops.groupnorm_silu(shifted, w, b, 32).float(),
                               ops.groupnorm_silu_plain(x, w, b, 32).float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,groups,variant,whole_row", K1_PLAN_CASES)
def test_groupnorm_silu_kernel_is_bitwise_repeatable(dev, shape, groups, variant, whole_row, dtype):
    """Each launch plan: K1 against its plain twin, and its output and saved
    ``[B, G]`` mean/rstd the same bits on two calls (a fixed reduction
    order); the output without statistics is the same as with them."""
    x, w, b = _gn_args(shape, dtype, dev)
    plan = ops.groupnorm_silu_plan(shape[0], shape[1] * shape[2], shape[3], groups, x.element_size(), 16)
    assert (plan.variant, plan.slab_groups == groups) == (variant, whole_row)
    first = ops.groupnorm_silu_forward(x, w, b, groups)
    torch.testing.assert_close(first[0].float(), ops.groupnorm_silu_plain(x, w, b, groups).float(), **TOL[dtype])
    second = ops.groupnorm_silu_forward(x, w, b, groups)
    assert all(torch.equal(a, c) for a, c in zip(first, second))
    assert torch.equal(ops.groupnorm_silu(x, w, b, groups), first[0])


def test_groupnorm_silu_kernel_refuses_a_plan_that_does_not_fit(dev):
    """The C entry point checks the launch plan it is given against the
    shape and the pointers, and returns an error instead of launching."""
    from baddiffusion_tpu_torch.ops import groupnorm as gn

    x, w, b = _gn_args((2, 8, 8, 128), torch.bfloat16, dev)
    out = torch.empty_like(x)
    plan = gn.groupnorm_silu_plan(2, 64, 128, 32, 2, 16)
    stream = torch.cuda.current_stream().cuda_stream

    def call(**change):
        p = plan._replace(**change)
        return gn._forward_kernel()(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), None, None, 2, 64, 128,
                                    32, p.slab_groups, p.vec, p.threads, p.smem_bytes, 1, 1e-5, 1, x.get_device(), stream)

    assert call() == 0
    for change in (dict(smem_bytes=plan.smem_bytes - 16), dict(slab_groups=3), dict(vec=16),
                   dict(threads=plan.threads + 1), dict(smem_bytes=300_000)):
        assert call(**change) != 0, change
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ops.groupnorm_silu_plain(x, w, b, 32).float(), **TOL[torch.bfloat16])


def test_groupnorm_silu_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x, w, b = _gn_args((2, 4, 4, 64), torch.float32, dev)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        ops.groupnorm_silu(x.permute(0, 2, 1, 3), w, b, 32)  # strided, not NHWC-contiguous
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.groupnorm_silu(x.half(), w.half(), b.half(), 32)
    with pytest.raises(ValueError, match="weight"):
        ops.groupnorm_silu(x, w.to(torch.bfloat16), b, 32)
    with pytest.raises(ValueError, match="not divisible"):
        ops.groupnorm_silu(x, w, b, 24)
    # differentiable: a tensor that needs a gradient runs K1, then K2 backward
    x.requires_grad_()
    ops.groupnorm_silu(x, w, b, 32).sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape and torch.isfinite(x.grad).all()


def test_launch_counters_count_kernel_launches_only(dev):
    ops.reset_launch_counts()
    x, w, b = _gn_args((1, 2, 2, 64), torch.float32, dev)
    ops.groupnorm_silu(x, w, b, 32)
    ops.groupnorm_silu_plain(x, w, b, 32)
    q = torch.randn(1, 2, 3, 8, device=dev)
    ops.attention(q, q, q, 0.5)
    ops.attention_plain(q, q, q, 0.5)
    ops.groupnorm_silu(x.cpu(), w.cpu(), b.cpu(), 32)
    _, mean, rstd = ops.groupnorm_silu_forward(x, w, b, 32)
    ops.groupnorm_silu_backward(x, w, b, mean, rstd, x, 32)
    ops.groupnorm_silu_backward_plain(x, w, b, mean, rstd, x, 32)
    y = x.permute(0, 3, 1, 2)
    ops.bias_shift(y, b)
    ops.bias_shift_plain(y, b)
    ops.bias_shift(y.cpu(), b.cpu())
    ops.bias_shift_backward(y)
    ops.bias_shift_backward_plain(y)
    assert ops.launch_counts() == {"groupnorm_silu": 2, "groupnorm_silu_backward": 1, "attention": 1,
                                   "bias_shift": 1, "bias_shift_backward": 1, "vq_nearest": 0}


def _k2_check(x, w, b, groups, dtype, cotangent_seed=1):
    """K1's statistics against the plain ones, K2 against its twin on them
    (dx: TOL; dγ/dβ: f32 sums in another order, atol 1e-4·max|ref|), and a
    second K2 call giving the same dγ/dβ bits."""
    out, mean, rstd = ops.groupnorm_silu_forward(x, w, b, groups, 1e-6)
    mean_p, rstd_p = ops.groupnorm_stats_plain(x, groups, 1e-6)
    torch.testing.assert_close(mean, mean_p, atol=1e-6, rtol=0.0)
    torch.testing.assert_close(rstd, rstd_p, atol=0.0, rtol=1e-5)
    torch.testing.assert_close(out.float(), ops.groupnorm_silu_plain(x, w, b, groups, 1e-6).float(), **TOL[dtype])
    g = torch.Generator(x.device).manual_seed(cotangent_seed)
    ct = torch.randn(x.shape, generator=g, device=x.device).to(dtype)
    dx, dg, db = ops.groupnorm_silu_backward(x, w, b, mean, rstd, ct, groups)
    dx_p, dg_p, db_p = ops.groupnorm_silu_backward_plain(x, w, b, mean, rstd, ct, groups)
    assert dx.dtype == dtype and dg.dtype == db.dtype == torch.float32
    torch.testing.assert_close(dx.float(), dx_p.float(), **TOL[dtype])
    for got, want in ((dg, dg_p), (db, db_p)):
        torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max().item(), rtol=0.0)
    _, dg2, db2 = ops.groupnorm_silu_backward(x, w, b, mean, rstd, ct, groups)
    assert torch.equal(dg, dg2) and torch.equal(db, db2)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,groups", GN_CASES)
def test_groupnorm_silu_backward_kernel_matches_plain(dev, shape, groups, dtype):
    _k2_check(*_gn_args(shape, dtype, dev), groups, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_groupnorm_silu_backward_kernel_takes_misaligned_storage(dev, dtype):
    x, w, b = _gn_args((2, 4, 4, 256), dtype, dev)
    shifted = torch.empty(x.numel() + 1, dtype=dtype, device=dev)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    _k2_check(shifted, w, b, 32, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,groups,variant,whole_row", K2_PLAN_CASES)
def test_groupnorm_silu_backward_kernel_is_bitwise_repeatable(dev, shape, groups, variant, whole_row, dtype):
    """Each of K2's launch plans: against its plain twin on K1's statistics
    (as ``_k2_check``), and dx, dγ, dβ the same bits on two calls (a fixed
    reduction order)."""
    x, w, b = _gn_args(shape, dtype, dev)
    plan = ops.groupnorm_silu_backward_plan(shape[0], shape[1] * shape[2], shape[3], groups, x.element_size(), 16)
    assert (plan.variant, plan.slab_groups == groups) == (variant, whole_row)
    _k2_check(x, w, b, groups, dtype)
    _, mean, rstd = ops.groupnorm_silu_forward(x, w, b, groups)
    ct = torch.randn(shape, generator=torch.Generator(dev).manual_seed(3), device=dev).to(dtype)
    first = ops.groupnorm_silu_backward(x, w, b, mean, rstd, ct, groups)
    second = ops.groupnorm_silu_backward(x, w, b, mean, rstd, ct, groups)
    assert all(torch.equal(a, c) for a, c in zip(first, second))


def test_groupnorm_silu_backward_kernel_takes_the_widest_group_the_forward_takes(dev):
    """One bf16 group of 4096 channels: 512 packs of 8, K2's only plan with
    8-element packs."""
    x, w, b = _gn_args((1, 2, 2, 4096), torch.bfloat16, dev)
    assert ops.groupnorm_silu_backward_plan(1, 4, 4096, 1, 2, 16).vec == 8
    _k2_check(x, w, b, 1, torch.bfloat16)


def test_groupnorm_silu_backward_kernel_refuses_a_plan_that_does_not_fit(dev):
    """``bd_groupnorm_silu_bwd`` checks the launch plan it is given against
    the shape and the pointers, and returns an error instead of launching."""
    from baddiffusion_tpu_torch.ops import groupnorm as gn

    x, w, b = _gn_args((2, 8, 8, 128), torch.bfloat16, dev)
    _, mean, rstd = ops.groupnorm_silu_forward(x, w, b, 32)
    ct = torch.randn(x.shape, generator=torch.Generator(dev).manual_seed(1), device=dev).to(torch.bfloat16)
    dx = torch.empty_like(x)
    buf = torch.empty(3 * 2 * 128, dtype=torch.float32, device=dev)
    plan = gn.groupnorm_silu_backward_plan(2, 64, 128, 32, 2, 16)
    stream = torch.cuda.current_stream().cuda_stream

    def call(stage=1, **change):
        p = plan._replace(**change)
        return gn._backward_kernel()(x.data_ptr(), w.data_ptr(), b.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                                     ct.data_ptr(), dx.data_ptr(), buf.data_ptr() + 2 * 128 * 4, buf.data_ptr(),
                                     2, 64, 128, 32, p.slab_groups, p.vec, p.threads, p.smem_bytes, stage, 1,
                                     x.get_device(), stream)

    assert call() == 0
    for change in (dict(smem_bytes=plan.smem_bytes - 16), dict(slab_groups=3), dict(vec=16),
                   dict(threads=plan.threads + 1), dict(smem_bytes=300_000), dict(stage=0), dict(stage=7)):
        assert call(**change) != 0, change
    torch.cuda.synchronize()
    want = ops.groupnorm_silu_backward_plain(x, w, b, mean, rstd, ct, 32)
    torch.testing.assert_close(dx.float(), want[0].float(), **TOL[torch.bfloat16])
    for got, ref in ((buf[:128], want[1]), (buf[128:256], want[2])):
        torch.testing.assert_close(got, ref, atol=1e-4 * ref.abs().max().item(), rtol=0.0)


def test_groupnorm_silu_backward_wrapper_refuses_what_the_kernel_does_not_take(dev):
    wide = torch.zeros(1, 1, 1, 8192, device=dev)  # one group of 2048 packs: wider than a block
    stat = torch.zeros(1, 1, device=dev)
    with pytest.raises(ValueError, match="at most 512 packs"):
        ops.groupnorm_silu_backward(wide, wide[0, 0, 0], wide[0, 0, 0], stat, stat, wide, 1)
    x, w, b = _gn_args((2, 2, 2, 512), torch.float32, dev)
    _, mean, rstd = ops.groupnorm_silu_forward(x, w, b, 32)
    with pytest.raises(ValueError, match="mean"):
        ops.groupnorm_silu_backward(x, w, b, mean[:, :8].contiguous(), rstd, x, 32)
    with pytest.raises(ValueError, match="grad_out"):
        ops.groupnorm_silu_backward(x, w, b, mean, rstd, x.to(torch.bfloat16), 32)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_groupnorm_silu_gradient_equals_autograd_through_plain(dev, dtype):
    """The autograd Function (K1 with statistics, K2) against autograd
    through ``groupnorm_silu_plain`` on the card; dγ/dβ as in ``_k2_check``."""
    x, w, b = _gn_args((4, 8, 8, 128), dtype, dev)
    ct = torch.randn(x.shape, generator=torch.Generator(dev).manual_seed(2), device=dev).to(dtype)
    grads = []
    for fn in (ops.groupnorm_silu, ops.groupnorm_silu_plain):
        args = [a.detach().clone().requires_grad_() for a in (x, w, b)]
        grads.append(torch.autograd.grad(fn(*args, 32, 1e-5), args, ct))
    (dx, dg, db), (dx_p, dg_p, db_p) = grads
    torch.testing.assert_close(dx.float(), dx_p.float(), **(TOL[dtype] if dtype == torch.float32 else
                                                           dict(atol=2e-2, rtol=1e-2)))
    for got, want in ((dg, dg_p), (db, db_p)):
        torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max().item(), rtol=1e-4)


# [B, H, T, D]: D = 8, 16, 24 and 40 past the packed plan, the largest D with
# a partial last K/V tile, the longest T (tf32x3 in f32; in bf16 the first
# four and the sixth are tiled, the fifth wide); then the packed plan (the
# UNet's 4- and 1-token calls, T = 16 at D = 32, D = 24) and the tiled plan in
# bf16 at D = 8, 16, 64, 128 and 256, ragged T, T = 1 and T = 1024; then the
# envelope's long end, T = 4096: the VQ-VAE's one 512-wide head (tf32x3 and
# wide), and D = 8, 64 and 256 (tiled in bf16); then the wide plan's depths
# past 256 (264, 384, 512) at T = 1, ragged T and a partial last key tile,
# each also in f32 (tf32x3)
ATTN_CASES = [(2, 3, 17, 8), (1, 2, 33, 16), (2, 3, 17, 24), (2, 2, 7, 40), (1, 1, 1000, 512), (1, 2, 1024, 8),
              (2, 64, 4, 8), (2, 64, 1, 8), (3, 5, 16, 32), (1, 2, 7, 24),
              (2, 4, 256, 8), (2, 3, 40, 16), (2, 3, 100, 64), (1, 2, 64, 128), (2, 1, 256, 256), (1, 1, 16, 256),
              (1, 2, 1, 256), (1, 2, 1024, 64),
              (1, 1, 4096, 512), (1, 2, 4096, 8), (1, 2, 4096, 64), (1, 1, 4096, 256), (1, 1, 4095, 136),
              (1, 2, 1, 264), (2, 1, 33, 264), (1, 2, 100, 384), (2, 1, 1, 512), (1, 3, 47, 512), (8, 1, 64, 512),
              (1, 1, 2049, 384)]


def _qkv(shape, dtype, dev, seed=None):
    g = torch.Generator(dev).manual_seed(sum(shape) if seed is None else seed)
    return tuple(torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(3))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", ATTN_CASES)
def test_attention_kernel_matches_plain(dev, shape, dtype):
    q, k, v = _qkv(shape, dtype, dev)
    scale = shape[-1] ** -0.5
    got = ops.attention(q, k, v, scale)
    torch.testing.assert_close(got.float(), ops.attention_plain(q, k, v, scale).float(), **TOL[dtype])


# (shape, dtype, the plan's variant): each variant in each dtype it takes;
# tf32x3_wg at depth 64 and 32 (D = 8 and 32); tf32x3 at each depth a warp
# may own (64 and 128: [16, 1, 4096, 512] takes 128 where the grid is large,
# [8, 1, 256, 512] 64) and T = 1, wide at both depths (256 at T = 4096, 128
# on a short grid), D = 264 and 384
ATTN_PLAN_CASES = [((128, 64, 4, 8), torch.bfloat16, "packed"), ((16, 64, 1, 8), torch.float32, "packed"),
                   ((4, 64, 256, 8), torch.bfloat16, "tiled"), ((2, 3, 100, 64), torch.bfloat16, "tiled"),
                   ((16, 1, 256, 256), torch.bfloat16, "tiled"), ((4, 8, 1024, 64), torch.bfloat16, "tiled"),
                   ((2, 1, 256, 512), torch.bfloat16, "wide"), ((2, 3, 100, 64), torch.float32, "tf32x3_wg"),
                   ((2, 1, 4096, 512), torch.float32, "tf32x3"), ((2, 1, 4096, 512), torch.bfloat16, "wide"),
                   ((2, 2, 4096, 32), torch.bfloat16, "tiled"),
                   ((4, 32, 256, 8), torch.float32, "tf32x3_wg"), ((16, 14, 1024, 32), torch.float32, "tf32x3_wg"),
                   ((16, 1, 4096, 512), torch.float32, "tf32x3"), ((8, 1, 256, 512), torch.float32, "tf32x3"),
                   ((2, 1, 1, 512), torch.float32, "tf32x3"), ((16, 1, 4096, 512), torch.bfloat16, "wide"),
                   ((1, 2, 1, 264), torch.bfloat16, "wide"), ((2, 1, 100, 384), torch.bfloat16, "wide")]


@pytest.mark.parametrize("shape,dtype,variant", ATTN_PLAN_CASES)
def test_attention_kernel_is_bitwise_repeatable(dev, shape, dtype, variant):
    """Each variant: against the plain twin, and the same bits on two calls
    (no split over keys, no atomics; tf32x3 and wide add the warps' partial
    scores in a fixed order; tf32x3_wg's products are summed in one order)."""
    b, h, t, d = shape
    assert ops.attention_plan(b * h, t, d, dtype).variant == variant
    q, k, v = _qkv(shape, dtype, dev)
    first = ops.attention(q, k, v, d**-0.5)
    torch.testing.assert_close(first.float(), ops.attention_plain(q, k, v, d**-0.5).float(), **TOL[dtype])
    assert torch.equal(first, ops.attention(q, k, v, d**-0.5))


def test_attention_kernel_refuses_a_plan_that_does_not_fit(dev):
    """``bd_attention_fwd`` checks the launch plan it is given against the
    shape, the dtype and the pointers, and returns an error instead of
    launching."""
    import importlib

    attn = importlib.import_module("baddiffusion_tpu_torch.ops.attention")  # the module, not ops.attention
    stream = torch.cuda.current_stream().cuda_stream

    def call(q, plan, dtype_code=1, ptr_offset=0, **change):
        p = plan._replace(**change)
        b, h, t, d = q.shape
        out = torch.empty_like(q)
        rc = attn._kernel()(q.data_ptr() + ptr_offset, q.data_ptr(), q.data_ptr(), out.data_ptr(), b * h, t, d,
                            d**-0.5, dtype_code, attn.VARIANTS.index(p.variant), p.threads, p.rows, p.key_tile,
                            p.depth, p.smem_bytes, p.stages, q.get_device(), stream)
        return rc, out

    for shape, dtype in (((2, 3, 100, 64), torch.bfloat16), ((2, 64, 4, 8), torch.bfloat16),
                         ((2, 1, 40, 512), torch.float32), ((2, 1, 40, 512), torch.bfloat16),
                         ((2, 3, 100, 32), torch.float32)):
        q = _qkv(shape, dtype, dev)[0]
        b, h, t, d = shape
        plan = ops.attention_plan(b * h, t, d, dtype)
        code = 0 if dtype == torch.float32 else 1
        rc, out = call(q, plan, code)
        assert rc == 0
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ops.attention_plain(q, q, q, d**-0.5).float(), **TOL[dtype])
        bad = [dict(smem_bytes=plan.smem_bytes + 16), dict(rows=plan.rows + 1), dict(threads=plan.threads + 32),
               dict(depth=plan.depth + 8), dict(ptr_offset=8),
               dict(variant="tiled") if plan.variant == "packed" else dict(variant="packed", key_tile=0, smem_bytes=0)]
        if plan.variant == "tiled":
            bad += [dict(dtype_code=0), dict(key_tile=plan.key_tile // 2), dict(rows=48, threads=96)]
        if plan.variant in ("tf32x3", "wide"):  # the other dtype, a key tile or depth a warp not instantiated
            bad += [dict(dtype_code=1 - code), dict(key_tile=plan.key_tile * 4),
                    dict(depth=2 * plan.depth, threads=plan.threads), dict(variant="tiled"), dict(stages=2)]
        if plan.variant == "tf32x3_wg":  # bf16, another ring, key tile or depth, no ring, the split plan's name
            bad += [dict(dtype_code=1), dict(stages=plan.stages + 1), dict(stages=0), dict(key_tile=32),
                    dict(depth=64, smem_bytes=ops.attention_plan(b * h, t, 64, dtype).smem_bytes,
                         stages=ops.attention_plan(b * h, t, 64, dtype).stages),
                    dict(variant="tf32x3", stages=0)]
        for change in bad:
            assert call(q, plan, **{"dtype_code": code, **change})[0] != 0, (shape, change)
    # past the envelope's long end, with the plan of T = 4096
    q = torch.zeros(1, 1, 4097, 8, device=dev)
    assert call(q, ops.attention_plan(1, 4096, 8, torch.float32), 0)[0] != 0


# tf32x3_wg's shapes: the LDM UNet's three attention resolutions at the
# sampling batch and T = 1024 at the measure's (B = 256); NCSN++ 256 px at
# 16x16 and the 256 px scratch UNet; ragged T (100, 33, 4093, 65, 150) at
# D = 8, 16, 40 and 64; an odd count of heads with T <= 64 (two a block)
WG_CASES = [(16, 14, 1024, 32), (16, 21, 256, 32), (16, 28, 64, 32), (256, 14, 1024, 32), (2, 32, 256, 8),
            (4, 64, 256, 8), (2, 3, 100, 8), (1, 3, 33, 16), (1, 1, 4093, 40), (2, 3, 100, 64), (1, 2, 65, 64),
            (3, 1, 150, 16), (5, 1, 40, 32)]


@pytest.mark.parametrize("shape", WG_CASES)
def test_attention_wg_kernel_matches_plain_and_repeats(dev, shape):
    """tf32x3_wg against the plain twin at f32 atol 1e-5 (the twin in slices
    of the batch: [256, 14, 1024, 1024] scores would take 15 GiB), and the
    same bits on a second call."""
    b, h, t, d = shape
    assert ops.attention_plan(b * h, t, d, torch.float32).variant == "tf32x3_wg"
    q, k, v = _qkv(shape, torch.float32, dev)
    first = ops.attention(q, k, v, d**-0.5)
    for i in range(0, b, 16):
        want = ops.attention_plain(q[i:i + 16], k[i:i + 16], v[i:i + 16], d**-0.5)
        torch.testing.assert_close(first[i:i + 16], want, **TOL[torch.float32])
    assert torch.equal(first, ops.attention(q, k, v, d**-0.5))


def test_attention_wg_kernel_captures_and_replays_in_a_cuda_graph(dev):
    """tf32x3_wg inside a CUDA graph (as the segment graphs take it): its
    tensor maps are kernel parameters built at capture, so a replay on new
    values in the captured buffers gives the eager call's bits."""
    shape = (4, 14, 256, 32)
    q, k, v = _qkv(shape, torch.float32, dev)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ops.attention(q, k, v, 32**-0.5)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.attention(q, k, v, 32**-0.5)
    for seed in (3, 4):
        for a, b in zip((q, k, v), _qkv(shape, torch.float32, dev, seed=seed)):
            a.copy_(b)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ops.attention(q, k, v, 32**-0.5))


@pytest.mark.parametrize("name,wg", [("LDM_CELEBA_HQ_256_UNET", 16), ("DDPM_CIFAR10_32", 0),
                                     ("DDPM_EMA_CELEBAHQ_256", 0)])
def test_f32_unet_forward_runs_its_heads_of_32_on_tf32x3_wg(dev, name, wg):
    """An f32 forward at B=1: CompVis/ldm-celebahq-256's UNet makes 16 K3
    launches, all 16 on tf32x3_wg (heads of 32 at T = 1024, 256, 64); the
    published DDPMs' one-head attention (D = 256, 512) none."""
    from baddiffusion_tpu_torch import model_configs

    cfg = getattr(model_configs, name)
    model = UNet2DModel(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, cfg.sample_size, cfg.sample_size, cfg.in_channels, device=dev)
    ops.reset_launch_counts()
    with torch.no_grad():
        model(x, torch.tensor([10], device=dev))
    counts = ops.attention_variant_counts()
    assert counts["tf32x3_wg"] == wg and sum(counts.values()) == ops.launch_counts()["attention"]
    assert ops.launch_counts()["attention"] == (16 if wg else 6)


def test_attention_wrapper_refuses_outside_the_envelope(dev):
    for shape in [(1, 1, 4097, 8), (1, 1, 4097, 512), (1, 1, 4, 4), (1, 1, 4, 12), (1, 1, 4, 520)]:
        q = torch.zeros(shape, device=dev)
        with pytest.raises(ValueError, match="envelope"):
            ops.attention(q, q, q, 1.0)
    q = torch.zeros(1, 2, 4, 8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        ops.attention(q, q.transpose(1, 2).contiguous().transpose(1, 2), q, 1.0)
    shifted = torch.zeros(q.numel() + 1, device=dev)[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.attention(shifted, q, q, 1.0)


@pytest.mark.parametrize("shape", [(2, 2, 64, 64), (1, 1, 256, 256)])
def test_attention_gradient_through_the_tiled_forward(dev, shape):
    """``_Attention`` on bf16 inputs that take the tiled plan: the forward is
    the kernel (counted once), the backward the plain f32 VJP, against
    autograd through ``attention_plain`` (both round to bf16 once)."""
    b, h, t, d = shape
    assert ops.attention_plan(b * h, t, d, torch.bfloat16).variant == "tiled"
    q, k, v = _qkv(shape, torch.bfloat16, dev)
    ct = torch.randn(shape, generator=torch.Generator(dev).manual_seed(5), device=dev).to(torch.bfloat16)
    grads = []
    ops.reset_launch_counts()
    for fn in (ops.attention, ops.attention_plain):
        args = [a.detach().clone().requires_grad_() for a in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*args, d**-0.5), args, ct))
    assert ops.launch_counts()["attention"] == 1
    for got, want in zip(*grads):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=1e-2)


# (B, C, H, W, dtype, with a row): the cells' shapes (celebahq-256's 256² level
# at B=16 with and without its time embedding, its 8² level, conv_out's C = 3;
# cifar10-32's measure at B=256 in f32), then odd widths and a ragged grid
SHIFT_CASES = [(16, 128, 256, 256, torch.bfloat16, True), (16, 128, 256, 256, torch.bfloat16, False),
               (16, 512, 8, 8, torch.bfloat16, True), (16, 3, 256, 256, torch.bfloat16, False),
               (256, 128, 32, 32, torch.float32, True), (256, 3, 32, 32, torch.float32, False),
               (3, 37, 5, 7, torch.float32, True), (3, 37, 5, 7, torch.bfloat16, True),
               (2, 1024, 3, 3, torch.float32, False), (1, 96, 1, 1, torch.bfloat16, True)]


def _shift_args(b, c, h, w, dtype, with_row, dev, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    y = torch.randn(b, c, h, w, generator=g, device=dev).to(dtype).contiguous(memory_format=torch.channels_last)
    bias = 0.02 * torch.randn(c, generator=g, device=dev)
    row = torch.randn(b, c, generator=g, device=dev).to(dtype) if with_row else None
    return y, bias, row


@pytest.mark.parametrize("b,c,h,w,dtype,with_row", SHIFT_CASES)
def test_bias_shift_kernels_match_plain(dev, b, c, h, w, dtype, with_row):
    """The forward kernel against its plain twin: the same f32 sum and one
    rounding, so the same bits, in place (the tensor it was given, at the
    same address). The backward against its twin (f32 sums in another order:
    atol 1e-4 of the largest reference value, the row's gradient also one
    bf16 rounding), and bitwise over two calls."""
    y, bias, row = _shift_args(b, c, h, w, dtype, with_row, dev)
    want = ops.bias_shift_plain(y.clone(), bias, row)
    ptr = y.data_ptr()
    got = ops.bias_shift(y, bias, row)
    assert got is y and got.data_ptr() == ptr and torch.equal(got, want)
    g = torch.randn(y.shape, generator=torch.Generator(dev).manual_seed(1), device=dev).to(dtype)
    g = g.contiguous(memory_format=torch.channels_last)
    row_dtype = dtype if with_row else None
    first = ops.bias_shift_backward(g, row_dtype)
    ref = ops.bias_shift_backward_plain(g, row_dtype)
    torch.testing.assert_close(first[0], ref[0], atol=1e-4 * ref[0].abs().max().item(), rtol=0.0)
    if with_row:
        tol = dict(atol=1e-4 * ref[1].abs().max().item(), rtol=0.0 if dtype == torch.float32 else 2 ** -7)
        torch.testing.assert_close(first[1].float(), ref[1].float(), **tol)
    else:
        assert first[1] is None
    again = ops.bias_shift_backward(g, row_dtype)
    assert torch.equal(first[0], again[0]) and (not with_row or torch.equal(first[1], again[1]))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_bias_shift_kernel_takes_misaligned_storage(dev, dtype):
    """y and g a few bytes off 16-byte alignment: narrower packs."""
    b, c, h, w = 2, 64, 4, 5
    y0, bias, row = _shift_args(b, c, h, w, dtype, True, dev)
    store = torch.zeros(y0.numel() + 1, dtype=dtype, device=dev)
    y = store[1:].view(b, h, w, c).permute(0, 3, 1, 2)
    y.copy_(y0)
    assert y.is_contiguous(memory_format=torch.channels_last) and y.data_ptr() % 16
    assert torch.equal(ops.bias_shift(y, bias, row), ops.bias_shift_plain(y0, bias, row))
    ref = ops.bias_shift_backward_plain(y, dtype)
    got = ops.bias_shift_backward(y, dtype)
    torch.testing.assert_close(got[0], ref[0], atol=1e-4 * ref[0].abs().max().item(), rtol=0.0)


def test_bias_shift_kernels_refuse_what_they_do_not_take(dev):
    y, bias, row = _shift_args(2, 8, 3, 3, torch.float32, True, dev)
    with pytest.raises(ValueError, match="channels_last"):
        ops.bias_shift(y.contiguous(), bias, row)
    with pytest.raises(ValueError, match="channels_last"):
        ops.bias_shift_backward(y.contiguous())
    with pytest.raises(ValueError, match="bias must be"):
        ops.bias_shift(y, bias.cpu(), row)
    with pytest.raises(ValueError, match="row must be a \\[2, 8\\] torch.float32 tensor, contiguous"):
        ops.bias_shift(y, bias, row.t().contiguous().t())
    with pytest.raises(ValueError, match="not differentiable"):
        ops.bias_shift(y, bias.requires_grad_(), row)
    with pytest.raises(ValueError, match="at most 1024 packs"):
        ops.bias_shift(torch.zeros(1, 1031, 1, 1, device=dev), torch.zeros(1031, device=dev))


def test_bias_shift_captures_and_replays_in_a_cuda_graph(dev):
    """Forward and backward captured in one graph on a side stream, replayed
    on new inputs copied into the captured buffers: the same bits as eager
    calls on those inputs."""
    y, bias, row = _shift_args(4, 128, 16, 16, torch.bfloat16, True, dev)
    g = torch.randn(y.shape, device=dev).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    src = y.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ops.bias_shift(y.copy_(src), bias, row)
        ops.bias_shift_backward(g, torch.bfloat16)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.bias_shift(y.copy_(src), bias, row)
        dbias, drow = ops.bias_shift_backward(g, torch.bfloat16)
    for seed in (3, 4):
        gen = torch.Generator(dev).manual_seed(seed)
        src.copy_(torch.randn(src.shape, generator=gen, device=dev).to(torch.bfloat16))
        bias.copy_(torch.randn(bias.shape, generator=gen, device=dev))
        row.copy_(torch.randn(row.shape, generator=gen, device=dev).to(torch.bfloat16))
        g.copy_(torch.randn(g.shape, generator=gen, device=dev).to(torch.bfloat16))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ops.bias_shift(src.clone(), bias, row))
        want = ops.bias_shift_backward(g, torch.bfloat16)
        assert torch.equal(dbias, want[0]) and torch.equal(drow, want[1])


@pytest.mark.parametrize("with_row", [False, True], ids=["bias", "bias+row"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_conv2d_bias_shift_matches_autograd_on_the_card(dev, dtype, with_row):
    """The autograd Function (the bias-free conv, the forward kernel; the
    conv's backward and the reduce kernels) against autograd through the
    same conv and the unfused adds: the forward the same bits as the conv
    then the plain twin; the input's and the weight's gradients cuDNN's
    (TOL, the weight's summed in f32: atol 1e-4·max|ref|), the bias's and
    the row's the f32 sums (atol 1e-4·max|ref|, the row's also one bf16
    rounding); one launch of each kernel."""
    g = torch.Generator(dev).manual_seed(7)
    x = torch.randn(4, 16, 16, 64, generator=g, device=dev).to(dtype)
    weight = 0.05 * torch.randn(128, 64, 3, 3, generator=g, device=dev)
    bias = 0.02 * torch.randn(128, generator=g, device=dev)
    row = torch.randn(4, 128, generator=g, device=dev).to(dtype) if with_row else None
    ct = torch.randn(4, 16, 16, 128, generator=g, device=dev).to(dtype)
    conv = ((1, 1), (1, 1), (1, 1), 1)
    leaves = [t.clone().requires_grad_() for t in (x, weight, bias) + ((row,) if with_row else ())]
    ops.reset_launch_counts()
    out = ops.conv2d_bias_shift(*leaves[:3], leaves[3] if with_row else None, *conv)
    out.backward(ct)
    assert ops.launch_counts()["bias_shift"] == 1 and ops.launch_counts()["bias_shift_backward"] == 1
    bare = torch.convolution(x.permute(0, 3, 1, 2), weight.to(dtype), None, *conv[:3], False, (0, 0), 1)
    assert torch.equal(out.detach(), ops.bias_shift_plain(bare, bias, row).permute(0, 2, 3, 1))
    refs = [t.clone().requires_grad_() for t in (x, weight, bias) + ((row,) if with_row else ())]
    y = torch.nn.functional.conv2d(refs[0].permute(0, 3, 1, 2), refs[1].to(dtype), None, *conv).float()
    y = y + refs[2][None, :, None, None]
    if with_row:
        y = y + refs[3].float()[:, :, None, None]
    y.permute(0, 2, 3, 1).backward(ct.float())
    torch.testing.assert_close(leaves[0].grad.float(), refs[0].grad.float(), **TOL[dtype])
    for got, ref in zip(leaves[1:], refs[1:]):
        tol = dict(atol=1e-4 * ref.grad.abs().max().item(), rtol=0.0 if got.dtype == torch.float32 else 2 ** -7)
        torch.testing.assert_close(got.grad.float(), ref.grad.float(), **tol)


# (N, K, D): ragged N and K around the plan's blocks, tiles and chunks, every vector width the plan takes,
# the dimensions 1 to 8, and a codebook of several tiles
VQ_CASES = [(1, 1, 3), (1000, 8, 3), (12345, 8192, 3), (70001, 2049, 3), (5000, 33, 3), (3000, 100, 3),
            (4097, 1031, 3), (2000, 700, 3), (999, 64, 3), (300000, 4500, 3)]
VQ_MARGIN = 2.0 ** -18  # as the benchmark's near tie: within f32 rounding of ‖z‖² + ‖e‖²


def _vq_args(n, k, d, dev, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    return torch.randn(n, d, generator=g, device=dev), torch.randn(k, d, generator=g, device=dev)


def _assert_nearest(z, codebook, idx, zq, rows=1 << 16):
    """``idx`` is each vector's nearest code by the twin's expanded L2 (the
    twin's own code or one within f32 rounding of it), ``zq`` its row."""
    assert idx.dtype == torch.int64 and torch.equal(zq, codebook[idx])
    norms = codebook.square().sum(dim=1)
    for r in range(0, z.shape[0], rows):
        zb, got = z[r:r + rows], idx[r:r + rows]
        want = ops.vq_nearest_plain(zb, codebook)[0]
        d = zb.square().sum(1, keepdim=True) + norms[None, :] - 2.0 * zb @ codebook.T
        over = d.gather(1, got[:, None])[:, 0] - d.gather(1, want[:, None])[:, 0]
        near = over <= VQ_MARGIN * (zb.square().sum(dim=1) + norms[got])
        assert bool(((got == want) | near).all()), int((~((got == want) | near)).sum())


@pytest.mark.parametrize("n,k,d", VQ_CASES)
def test_vq_nearest_kernel_matches_plain(dev, n, k, d):
    """The kernel's code for each vector is the twin's, or within f32
    rounding of it; its rows are the codebook's; the same bits over two
    calls."""
    z, codebook = _vq_args(n, k, d, dev)
    idx, zq = ops.vq_nearest(z, codebook)
    _assert_nearest(z, codebook, idx, zq)
    again = ops.vq_nearest(z, codebook)
    assert torch.equal(idx, again[0]) and torch.equal(zq, again[1])


def test_vq_nearest_kernel_breaks_exact_ties_to_the_lowest_index(dev):
    """Codes repeated across chunks and tiles: every vector takes the first
    copy, as torch.argmin does; a vector on a code takes it."""
    base = torch.randn(40, 3, generator=torch.Generator(dev).manual_seed(5), device=dev)
    codebook = torch.cat([base, base.flip(0), base, torch.zeros(1, 3, device=dev), base])  # 161 codes
    z = torch.cat([codebook[:40] + 1e-3 * torch.randn(40, 3, device=dev), codebook[:40], torch.zeros(1, 3, device=dev)])
    idx, zq = ops.vq_nearest(z, codebook)
    _assert_nearest(z, codebook, idx, zq)
    assert torch.equal(idx[40:80], torch.arange(40, device=dev)) and int(idx[80]) == 120
    far = lambda n: torch.randn(n, 3, device=dev) + 50.0
    wide = torch.cat([far(2000), base, far(100), base])  # the first copies in the first tile, the second in the next
    assert ops.vq_nearest_plan(40, wide.shape[0], 3).tile == 2048
    assert torch.equal(ops.vq_nearest(base.contiguous(), wide)[0], torch.arange(2000, 2040, device=dev))


def test_vq_nearest_at_the_measure_shape_holds_no_distance_matrix(dev):
    """N = 256·64·64 vectors against 8192 codes of 3 (the LDM measure's
    decode): the twin's codes, row blocks at a time; bitwise over two calls;
    a peak under 1 GiB beyond the outputs, and one launch; through
    ``VectorQuantizer`` too."""
    from baddiffusion_tpu_torch.models.vae import VectorQuantizer

    z, codebook = _vq_args(256 * 64 * 64, 8192, 3, dev, seed=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    idx, zq = ops.vq_nearest(z, codebook)
    torch.cuda.synchronize()
    outputs = idx.numel() * 8 + zq.numel() * 4
    assert torch.cuda.max_memory_allocated() - base - outputs < 1 << 30
    assert ops.launch_counts()["vq_nearest"] == 1
    _assert_nearest(z, codebook, idx, zq)
    again = ops.vq_nearest(z, codebook)
    assert torch.equal(idx, again[0]) and torch.equal(zq, again[1])
    del again
    quantizer = VectorQuantizer(8192, 3).to(dev)
    quantizer.embedding.weight.data.copy_(codebook)
    latents = z.view(256, 64, 64, 3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        out, codes = quantizer(latents)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base - (out.numel() * 4 + codes.numel() * 8) < 1 << 30
    assert torch.equal(codes.reshape(-1), idx) and ops.launch_counts()["vq_nearest"] == 3


def test_vq_nearest_refuses_what_it_does_not_take(dev):
    z, codebook = _vq_args(10, 8, 3, dev)
    with pytest.raises(ValueError, match="contiguous float32"):
        ops.vq_nearest(z.double(), codebook)
    with pytest.raises(ValueError, match="contiguous float32"):
        ops.vq_nearest(z.t().contiguous().t(), codebook)
    with pytest.raises(ValueError, match="codebook must be"):
        ops.vq_nearest(z, codebook.cpu())
    with pytest.raises(ValueError, match="codebook must be"):
        ops.vq_nearest(z, codebook[:, :2].contiguous())
    with pytest.raises(ValueError, match="vectors of 3 elements"):
        ops.vq_nearest(*_vq_args(10, 8, 4, dev))


def test_k1_and_the_bias_shift_take_a_tensor_of_over_2_31_elements(dev):
    """The LDM decoder's 256 px stage at B=256: [256, 256, 256, 256] f32,
    2**32 elements. K1 and the forward shift on the whole tensor against
    their twins on batch rows below and above 2**31 elements."""
    b, hw, c = 256, 256, 256
    x = torch.empty(b, hw, hw, c, device=dev)
    for r in range(0, b, 32):  # drawn in slices: the generator's own offsets stay small
        x[r:r + 32].normal_(generator=torch.Generator(dev).manual_seed(r))
    w, bias = torch.rand(c, device=dev) + 0.5, 0.1 * torch.randn(c, device=dev)
    rows = [0, 1, 127, 128, 200, 255]
    with torch.no_grad():
        y = ops.groupnorm_silu(x, w, bias, 32, 1e-6)
        for r in rows:
            torch.testing.assert_close(y[r:r + 1], ops.groupnorm_silu_plain(x[r:r + 1], w, bias, 32, 1e-6),
                                       atol=1e-5, rtol=0.0)
        del y
        shift = torch.randn(b, c, device=dev)
        want = {r: ops.bias_shift_plain(x[r:r + 1].permute(0, 3, 1, 2).clone(), bias, shift[r:r + 1]) for r in rows}
        got = ops.bias_shift(x.permute(0, 3, 1, 2), bias, shift)
        for r in rows:
            assert torch.equal(got[r:r + 1], want[r])


@pytest.mark.parametrize("name,convs", [("DDPM_CIFAR10_32", 65), ("DDPM_EMA_CELEBAHQ_256", 96)])
def test_published_unet_forward_shifts_every_conv_on_the_card(dev, name, convs):
    """A bf16 forward of google/ddpm-cifar10-32 (65 convs) and
    google/ddpm-ema-celebahq-256 (96) at B=1: one bias_shift launch a conv,
    and a backward one bias_shift_backward launch a conv."""
    from baddiffusion_tpu_torch import model_configs

    cfg = getattr(model_configs, name)
    model = UNet2DModel(cfg, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, cfg.sample_size, cfg.sample_size, cfg.in_channels, device=dev)
    ops.reset_launch_counts()
    with torch.no_grad():
        model(x, torch.tensor([10], device=dev))
    assert ops.launch_counts()["bias_shift"] == convs
    ops.reset_launch_counts()
    model(x, torch.tensor([10], device=dev)).sum().backward()
    counts = ops.launch_counts()
    assert counts["bias_shift"] == convs and counts["bias_shift_backward"] == convs


SMALL = UNet2DConfig(
    sample_size=16, layers_per_block=1, block_out_channels=(32, 64), norm_num_groups=8, attention_head_dim=8,
    down_block_types=("DownBlock2D", "AttnDownBlock2D"), up_block_types=("AttnUpBlock2D", "UpBlock2D"),
)
# 2 fused norms per resnet: 2 down, 2 mid, 4 up; plus conv_norm_out
SMALL_GN, SMALL_ATTN = 2 * (2 + 2 + 4) + 1, 4
# 2 convs per resnet, 5 shortcuts (the second down block's 32 -> 64 and each up resnet's concat), a down- and
# an upsampler, conv_in and conv_out: each a bias_shift launch
SMALL_CONV = 2 * 8 + 5 + 2 + 2


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_small_unet_on_the_card_matches_the_cpu(dev, dtype):
    """The same f32 parameters computing in ``dtype`` on the card and on the
    CPU (the compute dtype as flax's: GroupNorm affines stay f32)."""
    cpu = UNet2DModel(SMALL, device="cpu", dtype=dtype)
    card = UNet2DModel(SMALL, dtype=dtype)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([5, 600])
    ops.reset_launch_counts()
    with torch.no_grad():
        got = card(x.to(dev), t.to(dev)).cpu()
        want = cpu(x, t)
    assert ops.launch_counts() == {"groupnorm_silu": SMALL_GN, "groupnorm_silu_backward": 0, "attention": SMALL_ATTN,
                                   "bias_shift": SMALL_CONV, "bias_shift_backward": 0,
                                   "vq_nearest": 0}
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 else dict(atol=0.1, rtol=0.05)
    torch.testing.assert_close(got, want, **tol)


def test_small_unet_train_step_on_the_card_matches_the_cpu(dev):
    """One f32 train step (no warmup) of the small UNet on the card and on
    the CPU with the same weights, batch and draws. Gradients before the
    optimizer: rtol 1e-4, atol 1e-5 of the largest (f32 sums in other
    orders). Loss and pre-clip grad norm: rtol 1e-4. Every kernel launched
    once per use: SMALL_GN K1 and K2, SMALL_ATTN K3."""
    from baddiffusion_tpu_torch.data import Backdoor, trigger_mask
    from baddiffusion_tpu_torch.schedulers import DDPMConfig, DDPMScheduler
    from baddiffusion_tpu_torch.training import create_train_state, make_optimizer, make_train_step

    bd = Backdoor()
    trigger = bd.get_trigger("BOX_8", 3, 16)
    target = bd.get_target("CORNER", trigger)
    sched = DDPMScheduler(DDPMConfig()).create_state().schedule
    g = torch.Generator().manual_seed(3)
    image = torch.randint(0, 256, (4, 16, 16, 3), generator=g, dtype=torch.uint8)
    is_clean = torch.tensor([True, False, True, False])
    t = torch.randint(0, 1000, (4,), generator=g)
    noise = torch.randn(4, 16, 16, 3, generator=g)
    results = {}
    for device in ("cpu", "cuda"):
        model = UNet2DModel(SMALL, device=device, generator=torch.Generator().manual_seed(0))
        opt, _ = make_optimizer(1e-3, num_warmup_steps=0, num_training_steps=100)
        state = create_train_state(model, opt, trigger, target, trigger_mask(trigger))
        step = make_train_step(model, opt, 1000, sched.alphas, sched.alphas_cumprod, device=device)
        step.loss(state, *(a.to(device) for a in (image, is_clean)), None, t.to(device), noise.to(device)).backward()
        grads = {k: p.grad.detach().cpu().clone() for k, p in state.params.items()}
        ops.reset_launch_counts()
        state, m = step(state, image, is_clean, None, timesteps=t, noise=noise)
        results[device] = (grads, float(m["loss"]), float(m["grad_norm"]), ops.launch_counts())
    (g_cpu, l_cpu, n_cpu, c_cpu), (g_card, l_card, n_card, c_card) = results["cpu"], results["cuda"]
    assert c_cpu == {"groupnorm_silu": 0, "groupnorm_silu_backward": 0, "attention": 0, "bias_shift": 0,
                     "bias_shift_backward": 0, "vq_nearest": 0}
    assert c_card == {"groupnorm_silu": SMALL_GN, "groupnorm_silu_backward": SMALL_GN, "attention": SMALL_ATTN,
                      "bias_shift": SMALL_CONV, "bias_shift_backward": SMALL_CONV, "vq_nearest": 0}
    assert l_card == pytest.approx(l_cpu, rel=1e-4) and n_card == pytest.approx(n_cpu, rel=1e-4)
    gmax = max(v.abs().max().item() for v in g_cpu.values())
    for k, want in g_cpu.items():
        torch.testing.assert_close(g_card[k], want, rtol=1e-4, atol=1e-5 * gmax, msg=k)


def test_device_prefetch_batches_are_ready_when_read(dev):
    """50 batches of 8 MB through ``device_prefetch``: each is read on the
    default stream right after the yield, on even batches with that stream
    idle (its read must wait for the side stream's copy) and on odd ones
    behind a large matmul (the batch's memory must not go to a later copy
    before the read runs), then dropped. Every read equals its host source."""
    from baddiffusion_tpu_torch.data import device_prefetch

    rng = np.random.RandomState(0)
    host = [{"image_u8": rng.randint(0, 256, (2048, 64, 64), dtype=np.uint8), "is_clean": rng.rand(2048) < 0.5}
            for _ in range(50)]
    a = torch.randn(4096, 4096, device=dev)
    reads = []
    for i, batch in enumerate(device_prefetch(iter(host), dev, size=2)):
        assert batch["image_u8"].is_cuda and batch["is_clean"].dtype == torch.bool
        if i % 2:
            for _ in range(4):
                a = a @ a / 64.0
        reads.append({k: v.clone() for k, v in batch.items()})
        del batch
    torch.cuda.synchronize()
    assert len(reads) == 50
    for got, want in zip(reads, host):
        for k in want:
            assert np.array_equal(got[k].cpu().numpy(), want[k]), k


def test_train_loop_on_the_card_matches_the_cpu(dev, tmp_path):
    """Two steps of ``train_loop`` (FAKE at 16 px, batch 4, one epoch) on the
    small UNet, on the card and on the CPU from the same weights, each step
    given the same draws from a CPU generator seeded by the step: the logged
    losses within rtol 1e-4, the parameters within Adam's sign-like
    tolerance (2·lr a step; all but 1e-3 within 1e-5), the same checkpoint
    step; on the card every GroupNorm+SiLU and attention call went through
    its kernel: SMALL_GN K1 and K2 and SMALL_ATTN K3 a step, SMALL_GN K1 and
    SMALL_ATTN K3 for each of the grids' 2 × 2 sampling forwards."""
    import json
    import os

    from baddiffusion_tpu_torch.data import DatasetLoader
    from baddiffusion_tpu_torch.pipelines import DiffusionPipeline
    from baddiffusion_tpu_torch.schedulers import DDPMConfig, DDPMScheduler
    from baddiffusion_tpu_torch.training import create_train_state, make_optimizer, make_train_step, train_loop

    class Log:
        def __init__(self):
            self.records, self.stalls = [], []

        def log(self, metrics, step=None):
            if "loss" in metrics:  # a step's record; the loop also logs each save's ckpt_stall_s
                self.records.append((step, metrics["loss"]))
            else:
                self.stalls.append((step, metrics["ckpt_stall_s"]))

    sched = DDPMScheduler(DDPMConfig())
    schedule = sched.create_state().schedule
    weights = UNet2DModel(SMALL, device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    results = {}
    for device in ("cpu", "cuda"):
        dsl = DatasetLoader("FAKE", fake_size=8, image_size=16, batch_size=4).set_poison("BOX_8", "CORNER")
        dsl.prepare_dataset()
        model = UNet2DModel(SMALL, device=device)
        model.load_state_dict(weights)
        opt, lr_schedule = make_optimizer(1e-3, num_warmup_steps=0, num_training_steps=100)
        state = create_train_state(model, opt, dsl.trigger, dsl.target, dsl.mask)
        step = make_train_step(model, opt, 1000, schedule.alphas, schedule.alphas_cumprod, device=device)

        def drawn(state, image_u8, is_clean, generator):
            assert generator.device.type == image_u8.device.type == device
            g = torch.Generator().manual_seed(100 + state.step)
            t, noise = torch.randint(0, 1000, (4,), generator=g), torch.randn(4, 16, 16, 3, generator=g)
            return step(state, image_u8, is_clean, None, timesteps=t, noise=noise)

        log = Log()
        out = str(tmp_path / device)
        ops.reset_launch_counts()
        state, n = train_loop(dsl=dsl, train_step=drawn, state=state, lr_schedule=lr_schedule, epochs=1, tracker=log,
                              out_dir=out, make_pipeline=lambda st: DiffusionPipeline(model, sched, device=device),
                              log_every=1, sample_n=2, sampling_steps=2)
        counts = ops.launch_counts()
        with open(os.path.join(out, "data.json")) as f:
            saved = json.load(f)
        assert [s for s, _ in log.stalls] == [2] and log.stalls[0][1] > 0
        results[device] = (log.records, {k: p.detach().cpu() for k, p in state.params.items()}, counts, saved, n)
    (l_cpu, p_cpu, c_cpu, s_cpu, n_cpu), (l_card, p_card, c_card, s_card, n_card) = results["cpu"], results["cuda"]
    assert n_cpu == n_card == 2 and s_cpu == s_card == {"epoch": 0, "step": 2, "ckpt": "ckpt"}
    assert [s for s, _ in l_card] == [s for s, _ in l_cpu] == [0, 1]
    for (_, a), (_, b) in zip(l_card, l_cpu):
        assert a == pytest.approx(b, rel=1e-4)
    diff = torch.cat([(p_card[k] - p_cpu[k]).abs().flatten() for k in p_cpu])
    assert diff.max().item() <= 4e-3 + 1e-6 and (diff > 1e-5).double().mean().item() <= 1e-3
    assert c_cpu == {"groupnorm_silu": 0, "groupnorm_silu_backward": 0, "attention": 0, "bias_shift": 0,
                     "bias_shift_backward": 0, "vq_nearest": 0}
    forwards = 2 + 2 * 2
    assert c_card == {"groupnorm_silu": SMALL_GN * forwards, "groupnorm_silu_backward": SMALL_GN * 2,
                      "attention": SMALL_ATTN * forwards, "bias_shift": SMALL_CONV * forwards,
                      "bias_shift_backward": SMALL_CONV * 2, "vq_nearest": 0}


ZOO = [v for k, v in sorted(vars(factory.DiffuserModelSched).items()) if k.endswith("_SCHED") and k != "LDM_SCHED"]


def _zoo_scheduler(name):
    if name == "KARRAS-VE":
        return KarrasVeScheduler()
    return factory._sched_spec(name)[0](False)


@pytest.mark.parametrize("name", ZOO + ["KARRAS-VE"])
def test_zoo_standin_chain_on_the_card_matches_the_cpu(dev, name):
    """Each scheduler's 10-step chain with the stand-in denoiser, from the
    same init and noise, on the card (under the sync guard: no step
    synchronises) and on the CPU: max err <= 1e-4·max|x| + 1e-4."""
    g = torch.Generator().manual_seed(3)
    init = torch.randn(4, 16, 16, 3, generator=g)
    noise = [torch.randn(4, 16, 16, 3, generator=g) for _ in range(20)]
    out = {}
    for device in ("cpu", "cuda"):
        source = [z.to(device) for z in noise]
        sched = _zoo_scheduler(name)
        state = sched.set_timesteps(sched.create_state(), 10)
        x0 = init.to(device)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error" if device == "cuda" else 0)
        try:
            out[device], _ = sample_chain(sched, state, lambda x, t: 0.1 * x + 0.05 * torch.sin(t.float() / 100.0)
                                          .view(-1, 1, 1, 1), x0, noise_source=source.__getitem__)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    ref, got = out["cpu"], out["cuda"].cpu()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item() + 1e-4


def test_small_unet_dpm_solver_chain_on_the_card_matches_the_cpu(dev):
    """A 10-step DPM-Solver++ O2 chain through DiffusionPipeline on the
    small UNet in f32, card (under the sync guard) against CPU, with the
    kernels' launches counted."""
    cpu = UNet2DModel(SMALL, device="cpu")
    card = UNet2DModel(SMALL)
    card.load_state_dict(cpu.state_dict())
    init = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(4))
    make = factory._make_get_pipeline
    want = make(cpu, "solver", False)(factory._sched_spec("DPM_SOLVER_PP_O2-SCHED")[0](False), device="cpu")(
        init=init, num_inference_steps=10, output_type="pt").sample
    pipe = make(card, "solver", False)(factory._sched_spec("DPM_SOLVER_PP_O2-SCHED")[0](False))
    init_card = init.to(dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = pipe(init=init_card, num_inference_steps=10, generator=torch.Generator(dev), output_type="pt")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ops.launch_counts() == {"groupnorm_silu": SMALL_GN * 10, "groupnorm_silu_backward": 0,
                                   "attention": SMALL_ATTN * 10, "bias_shift": SMALL_CONV * 10,
                                   "bias_shift_backward": 0, "vq_nearest": 0}
    got = out.sample.cpu()
    torch.testing.assert_close(got, want, atol=1e-3 * want.abs().max().item(), rtol=1e-3)


SEGMENT_CASES = {  # factory name, steps, segment, call keywords
    "ddpm-remainder": ("DDPM-SCHED", 12, 5, {}),
    "ddpm-movie": ("DDPM-SCHED", 10, 4, dict(save_every_step=True, capture_every=3)),
    "ddpm-start_from": ("DDPM-SCHED", 10, 2, dict(start_from=4)),
    "unipc": ("UNIPC-SCHED", 10, 3, {}),
    "pndm": ("PNDM-SCHED", 10, 4, {}),
    "sde-ve": ("SCORE-SDE-VE-SCHED", 10, 3, dict(save_every_step=True, capture_every=4)),
}


def _small_pipeline(name, dtype=torch.bfloat16):
    card = UNet2DModel(SMALL, generator=torch.Generator().manual_seed(7))
    make_scheduler, kind = factory._sched_spec(name)
    return factory._make_get_pipeline(card, kind, False)(make_scheduler(False)), card


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segment_graphs_replay_the_eager_chain_bitwise(dev, case):
    """The chain as CUDA graphs of ``seg`` steps against the eager chain, in
    bf16 on the small UNet from noise drawn by the pipeline: the sample, the
    images and the movie bitwise; a second call with another generator
    replays the cached graphs and equals that generator's eager chain; each
    caller's generator ends where the eager chain leaves it; the counters
    count the replays' launches (one forward a chain step, plus the capture's
    warm-up forward)."""
    name, n, seg, kw = SEGMENT_CASES[case]
    pipe, _ = _small_pipeline(name)
    pipe.compute_dtype = torch.bfloat16
    forwards = {"SCORE-SDE-VE-SCHED": 2 * n, "PNDM-SCHED": None}.get(name, n - kw.get("start_from", 0))
    for seed in (1, 2):
        gens = [torch.Generator(dev).manual_seed(seed) for _ in range(2)]
        pipe.segment_steps = None
        want = pipe(batch_size=3, generator=gens[0], num_inference_steps=n, output_type="pt", **kw)
        pipe.segment_steps = seg
        ops.reset_launch_counts()
        got = pipe(batch_size=3, generator=gens[1], num_inference_steps=n, output_type="pt", **kw)
        counts = ops.launch_counts()
        assert torch.equal(got.sample, want.sample) and torch.equal(got.images, want.images), (case, seed)
        if want.movie is not None:
            assert torch.equal(got.movie, want.movie) and torch.equal(got.movie[-1], got.images)
        assert torch.equal(gens[0].get_state(), gens[1].get_state())
        if forwards is not None:
            total = forwards + (1 if seed == 1 else 0)  # the first call captures, after one warm-up forward
            assert counts == {"groupnorm_silu": SMALL_GN * total, "groupnorm_silu_backward": 0,
                              "attention": SMALL_ATTN * total, "bias_shift": SMALL_CONV * total,
                              "bias_shift_backward": 0, "vq_nearest": 0}, (case, seed, counts)
    assert len(pipe._graphs) == 1


def test_segment_graphs_sample_weights_updated_in_place(dev):
    """The graphs read a copy of the UNet refreshed at every call: after the
    live weights change in place, a replay samples the new weights."""
    pipe, card = _small_pipeline("DDIM-SCHED")
    pipe.segment_steps = 3
    before = pipe(batch_size=2, generator=torch.Generator(dev).manual_seed(0), num_inference_steps=8,
                  output_type="pt").sample
    with torch.no_grad():
        for p in card.parameters():
            p.mul_(1.01)
    after = pipe(batch_size=2, generator=torch.Generator(dev).manual_seed(0), num_inference_steps=8,
                 output_type="pt").sample
    pipe.segment_steps = None
    eager = pipe(batch_size=2, generator=torch.Generator(dev).manual_seed(0), num_inference_steps=8,
                 output_type="pt").sample
    assert not torch.equal(before, after) and torch.equal(after, eager)
    assert len(pipe._graphs) == 1


def test_segment_graphs_refuse_a_noise_source_and_keep_a_bounded_cache(dev):
    pipe, _ = _small_pipeline("DDPM-SCHED")
    pipe.segment_steps = 2
    with pytest.raises(ValueError, match="noise_source"):
        pipe(batch_size=1, num_inference_steps=4, noise_source=lambda k: torch.zeros(1, 16, 16, 3))
    for b in range(1, 7):
        pipe(batch_size=b, num_inference_steps=4, output_type="pt")
    assert len(pipe._graphs) == 4 and [k[0][0] for k in pipe._graphs] == [3, 4, 5, 6]


def _small_step_world(device, layout_mesh=None, grad_accum=1):
    """The small UNet's f32 train step on ``device`` from seed 0, on a
    replicated layout over ``layout_mesh`` when given."""
    from baddiffusion_tpu_torch.data import Backdoor, trigger_mask
    from baddiffusion_tpu_torch.parallel import ParallelLayout
    from baddiffusion_tpu_torch.schedulers import DDPMConfig, DDPMScheduler
    from baddiffusion_tpu_torch.training import create_train_state, make_optimizer, make_train_step

    bd = Backdoor()
    trigger = bd.get_trigger("BOX_8", 3, 16)
    sched = DDPMScheduler(DDPMConfig()).create_state().schedule
    model = UNet2DModel(SMALL, device=device, generator=torch.Generator().manual_seed(0))
    opt, _ = make_optimizer(1e-3, num_warmup_steps=0, num_training_steps=100)
    state = create_train_state(model, opt, trigger, bd.get_target("CORNER", trigger), trigger_mask(trigger))
    layout = None if layout_mesh is None else ParallelLayout(layout_mesh, model, grad_accum=grad_accum)
    step = make_train_step(model, opt, 1000, sched.alphas, sched.alphas_cumprod, grad_accum=grad_accum,
                           device=device, layout=layout)
    return state, step, layout


def _small_batches(n=2, b=8):
    g = torch.Generator().manual_seed(5)
    return [(torch.randint(0, 256, (b, 16, 16, 3), generator=g, dtype=torch.uint8), torch.arange(b) % 3 != i,
             torch.randint(0, 1000, (b,), generator=g), torch.randn(b, 16, 16, 3, generator=g)) for i in range(n)]


def _small_steps(state, step, layout, device):
    out = []
    for image, is_clean, t, noise in _small_batches():
        if layout is not None:
            image, is_clean = layout.batch(image), layout.batch(is_clean)
        state, m = step(state, image.to(device), is_clean.to(device), None, timesteps=t, noise=noise)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return state, out


def test_world_of_one_nccl_rank_is_the_plain_step(dev, tmp_path, monkeypatch):
    """The step through a one-rank NCCL world (its all-reduce the identity)
    gives the plain step's bits: losses, grad norms and parameters. cuDNN
    picks deterministic algorithms here: some f32 weight-gradient algorithms
    accumulate with atomics, and two plain runs of this small f32 step then
    differ in the last bit themselves (the full-width bf16 step of
    ``chip_smoke.py`` phase 11 (a) matches bitwise without it)."""
    from baddiffusion_tpu_torch.parallel import distributed, make_mesh

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    runs = []
    for _ in range(2):
        state, step, _ = _small_step_world(dev)
        state, metrics = _small_steps(state, step, None, dev)
        runs.append((metrics, {k: p.detach().clone() for k, p in state.params.items()}))
    (want, want_params), (again, again_params) = runs
    assert again == want and all(torch.equal(again_params[k], v) for k, v in want_params.items())
    backend = distributed.initialize(dev, store=torch.distributed.FileStore(str(tmp_path / "store"), 1), rank=0,
                                     world_size=1, timeout_s=60)
    try:
        assert backend == "nccl"
        state, step, layout = _small_step_world(dev, make_mesh(dev))
        state, got = _small_steps(state, step, layout, dev)
    finally:
        distributed.shutdown()
    assert got == want
    assert all(torch.equal(state.params[k], v) for k, v in want_params.items())


def _launch_two_ranks(role, work):
    """Two processes of this file on cuda:0 (``--gpu 0,0``: gloo) in ``role``."""
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.dirname(os.path.abspath(__file__)))}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), role, str(r), str(work)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs


def test_two_ranks_sharing_the_card_match_one_rank(dev, tmp_path):
    """Two ranks on cuda:0 (``--gpu 0,0``: gloo) take 4 of the 8 rows each:
    they agree bitwise, and match one rank on the card (loss and grad norm
    rtol 1e-5; parameters within 2·lr a step, all but 1e-3 within 1e-6)."""
    state, step, _ = _small_step_world(dev)
    state, want = _small_steps(state, step, None, dev)
    _launch_two_ranks("train", tmp_path)
    got = [torch.load(str(tmp_path / f"rank{r}.pt")) for r in range(2)]
    assert got[0]["metrics"] == got[1]["metrics"]
    assert all(torch.equal(got[0]["params"][k], got[1]["params"][k]) for k in got[0]["params"])
    np.testing.assert_allclose(got[0]["metrics"], want, rtol=1e-5)
    diff = torch.cat([(got[0]["params"][k] - p.detach().cpu()).abs().flatten() for k, p in state.params.items()])
    assert diff.max() <= 2 * 2 * 1e-3 + 1e-6 and (diff > 1e-6).double().mean() <= 1e-3


def test_segment_graphs_on_a_mesh_replay_each_batch_s_eager_chain(dev, tmp_path):
    """On two ranks sharing the card, batches of 8 and then 7 (both 4 rows
    a rank once padded) in segments: each call's images and its caller's
    generator bitwise its eager chain's. Each rank's graphs draw the whole
    batch's noise and keep its rows, so the two batches capture apart."""
    _launch_two_ranks("segments", tmp_path)
    got = [torch.load(str(tmp_path / f"segments-rank{r}.pt")) for r in range(2)]
    assert got[0]["graphs"] == got[1]["graphs"] == 2
    assert all(torch.equal(a, b) for a, b in zip(got[0]["images"], got[1]["images"]))


def _two_rank_segments(dev, work, rank):
    """One rank's segmented DDPM chains on a mesh of two, each against the eager chain."""
    from baddiffusion_tpu_torch.parallel import make_mesh

    pipe, _ = _small_pipeline("DDPM-SCHED")
    pipe.mesh = make_mesh(dev)
    images = []
    for batch in (8, 7):
        gens = [torch.Generator(dev).manual_seed(batch) for _ in range(2)]
        pipe.segment_steps = None
        want = pipe(batch_size=batch, generator=gens[0], num_inference_steps=6, output_type="pt")
        pipe.segment_steps = 2
        got = pipe(batch_size=batch, generator=gens[1], num_inference_steps=6, output_type="pt")
        assert got.images.shape[0] == batch
        assert torch.equal(got.sample, want.sample) and torch.equal(got.images, want.images), batch
        assert torch.equal(gens[0].get_state(), gens[1].get_state()), batch
        images.append(got.images.cpu())
    torch.save({"graphs": len(pipe._graphs), "images": images}, os.path.join(work, f"segments-rank{rank}.pt"))


def _two_rank_main(role, rank, work):
    """One of two ranks on cuda:0 over gloo: ``train`` the small steps on its
    rows, ``segments`` the segmented chains on a mesh."""
    from baddiffusion_tpu_torch.config import shares_card
    from baddiffusion_tpu_torch.parallel import distributed, make_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ.update(WORLD_SIZE="2", LOCAL_RANK=str(rank))
    backend = distributed.initialize("cuda:0", shares_card("0,0"), store=torch.distributed.FileStore(
        os.path.join(work, f"store-{role}"), 2), rank=rank, world_size=2, timeout_s=120)
    assert backend == "gloo", backend
    dev = torch.device("cuda:0")
    if role == "segments":
        _two_rank_segments(dev, work, rank)
    else:
        state, step, layout = _small_step_world(dev, make_mesh(dev))
        state, metrics = _small_steps(state, step, layout, dev)
        torch.save({"metrics": metrics, "params": {k: p.detach().cpu() for k, p in state.params.items()}},
                   os.path.join(work, f"rank{rank}.pt"))
    distributed.shutdown()


if __name__ == "__main__":
    _two_rank_main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
