"""The port's CUDA kernels on the card, beyond the main path's shapes: every
pack width and lane layout, misaligned and partial-tile inputs, each launch
plan, the wrappers' refusals, the GroupNorm+SiLU backward (K2) and its
bitwise-repeatable dx, dγ and dβ, a small UNet on the card against the
CPU's plain path (forward, one train step, two steps of ``train_loop``), and
``device_prefetch``'s side-stream copies.

These tests need an NVIDIA GPU and skip without one. Run them on the card
without the JAX-side conftest (this file imports no JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from baddiffusion_tpu_torch import ops
from baddiffusion_tpu_torch.models import UNet2DConfig, UNet2DModel

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
                                    32, p.slab_groups, p.vec, p.threads, p.smem_bytes, 1, 1e-5, 1, stream)

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
    assert ops.launch_counts() == {"groupnorm_silu": 2, "groupnorm_silu_backward": 1, "attention": 1}


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
                                     2, 64, 128, 32, p.slab_groups, p.vec, p.threads, p.smem_bytes, stage, 1, stream)

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


# [B, H, T, D]: 8- and 16-lane rows, masked lanes (D 24, 40), the largest D
# with a partial last K/V tile, the longest T (rowwise in f32; in bf16 the
# first four and the last are tiled); then the packed plan (the UNet's 4- and
# 1-token calls, T = 16 at D = 32, D = 24) and the tiled plan in bf16 at
# D = 8, 16, 64, 128 and 256, ragged T, T = 1 and T = 1024
ATTN_CASES = [(2, 3, 17, 8), (1, 2, 33, 16), (2, 3, 17, 24), (2, 2, 7, 40), (1, 1, 1000, 512), (1, 2, 1024, 8),
              (2, 64, 4, 8), (2, 64, 1, 8), (3, 5, 16, 32), (1, 2, 7, 24),
              (2, 4, 256, 8), (2, 3, 40, 16), (2, 3, 100, 64), (1, 2, 64, 128), (2, 1, 256, 256), (1, 1, 16, 256),
              (1, 2, 1, 256), (1, 2, 1024, 64)]


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


# (shape, dtype, the plan's variant): each variant in each dtype it takes
ATTN_PLAN_CASES = [((128, 64, 4, 8), torch.bfloat16, "packed"), ((16, 64, 1, 8), torch.float32, "packed"),
                   ((4, 64, 256, 8), torch.bfloat16, "tiled"), ((2, 3, 100, 64), torch.bfloat16, "tiled"),
                   ((16, 1, 256, 256), torch.bfloat16, "tiled"), ((4, 8, 1024, 64), torch.bfloat16, "tiled"),
                   ((2, 1, 256, 512), torch.bfloat16, "rowwise"), ((2, 3, 100, 64), torch.float32, "rowwise")]


@pytest.mark.parametrize("shape,dtype,variant", ATTN_PLAN_CASES)
def test_attention_kernel_is_bitwise_repeatable(dev, shape, dtype, variant):
    """Each variant: against the plain twin, and the same bits on two calls
    (no split over keys, no atomics)."""
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
                            p.depth, p.smem_bytes, stream)
        return rc, out

    for shape, dtype in (((2, 3, 100, 64), torch.bfloat16), ((2, 64, 4, 8), torch.bfloat16),
                         ((2, 1, 40, 512), torch.float32)):
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
        for change in bad:
            assert call(q, plan, **{"dtype_code": code, **change})[0] != 0, (shape, change)


def test_attention_wrapper_refuses_outside_the_envelope(dev):
    for shape in [(1, 1, 1025, 8), (1, 1, 4, 4), (1, 1, 4, 12), (1, 1, 4, 520)]:
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


SMALL = UNet2DConfig(
    sample_size=16, layers_per_block=1, block_out_channels=(32, 64), norm_num_groups=8, attention_head_dim=8,
    down_block_types=("DownBlock2D", "AttnDownBlock2D"), up_block_types=("AttnUpBlock2D", "UpBlock2D"),
)
# 2 fused norms per resnet: 2 down, 2 mid, 4 up; plus conv_norm_out
SMALL_GN, SMALL_ATTN = 2 * (2 + 2 + 4) + 1, 4


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
    assert ops.launch_counts() == {"groupnorm_silu": SMALL_GN, "groupnorm_silu_backward": 0, "attention": SMALL_ATTN}
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
    assert c_cpu == {"groupnorm_silu": 0, "groupnorm_silu_backward": 0, "attention": 0}
    assert c_card == {"groupnorm_silu": SMALL_GN, "groupnorm_silu_backward": SMALL_GN, "attention": SMALL_ATTN}
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
            self.records = []

        def log(self, metrics, step=None):
            self.records.append((step, metrics["loss"]))

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
        results[device] = (log.records, {k: p.detach().cpu() for k, p in state.params.items()}, counts, saved, n)
    (l_cpu, p_cpu, c_cpu, s_cpu, n_cpu), (l_card, p_card, c_card, s_card, n_card) = results["cpu"], results["cuda"]
    assert n_cpu == n_card == 2 and s_cpu == s_card == {"epoch": 0, "step": 2, "ckpt": "ckpt"}
    assert [s for s, _ in l_card] == [s for s, _ in l_cpu] == [0, 1]
    for (_, a), (_, b) in zip(l_card, l_cpu):
        assert a == pytest.approx(b, rel=1e-4)
    diff = torch.cat([(p_card[k] - p_cpu[k]).abs().flatten() for k in p_cpu])
    assert diff.max().item() <= 4e-3 + 1e-6 and (diff > 1e-5).double().mean().item() <= 1e-3
    assert c_cpu == {"groupnorm_silu": 0, "groupnorm_silu_backward": 0, "attention": 0}
    forwards = 2 + 2 * 2
    assert c_card == {"groupnorm_silu": SMALL_GN * forwards, "groupnorm_silu_backward": SMALL_GN * 2,
                      "attention": SMALL_ATTN * forwards}
