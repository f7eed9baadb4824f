"""The conv bias-shift pair on the CPU (``ops/bias_shift.py``): its plain twin
against the unfused ``y + bias (+ row)``, and its autograd ``Function`` (the
bias-free conv, then the shift) against the conv and the unfused adds by
autograd, forward and every gradient; one autograd node a ``Conv2d`` call; the launch plan's rules; the wrapper's
refusals; and ``Conv2d`` with a row shift against ``nn.Conv2d`` plus the
broadcast add it replaces.
"""

import importlib

import pytest
import torch
from torch import nn

from baddiffusion_tpu_torch import ops
from baddiffusion_tpu_torch.models import Conv2d
from baddiffusion_tpu_torch.ops import (
    bias_shift,
    bias_shift_backward_plain,
    bias_shift_plain,
    bias_shift_plan,
    conv2d_bias_shift,
)

BS = importlib.import_module("baddiffusion_tpu_torch.ops.bias_shift")  # the module: ``ops.bias_shift`` is the function
DTYPES = [torch.float32, torch.bfloat16]
# conv_out's 3 channels, the UNets' 128 and 512, an odd width
CHANNELS = [3, 128, 512, 37]


def _inputs(c, dtype, seed, batch=2, h=5, w=6):
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(batch, c, h, w, generator=g).to(dtype).contiguous(memory_format=torch.channels_last)
    bias = 0.5 * torch.randn(c, generator=g)
    row = torch.randn(batch, c, generator=g).to(dtype)
    ct = torch.randn(batch, c, h, w, generator=g).to(dtype).contiguous(memory_format=torch.channels_last)
    return y, bias, row, ct


def _unfused(y, bias, row):
    """``y + bias (+ row)`` in f32 with autograd, as the port computed it
    before the pair (conv bias add, then the time embedding's add)."""
    out = y.float() + bias[None, :, None, None]
    return out if row is None else out + row.float()[:, :, None, None]


def _conv_inputs(c, dtype, seed, batch=2, h=5, w=6, c_in=4):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, h, w, c_in, generator=g).to(dtype)
    weight = 0.3 * torch.randn(c, c_in, 3, 3, generator=g)
    bias = 0.5 * torch.randn(c, generator=g)
    row = torch.randn(batch, c, generator=g).to(dtype)
    ct = torch.randn(batch, h, w, c, generator=g).to(dtype)
    return x, weight, bias, row, ct


CONV = ((1, 1), (1, 1), (1, 1), 1)  # stride, padding, dilation, groups


@pytest.mark.parametrize("with_row", [False, True], ids=["bias", "bias+row"])
@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plain_and_function_match_the_unfused_formula(dtype, c, with_row):
    """Forward: the plain twin shifts y in place within one rounding of the
    f32 formula (f32: the two adds in another order, a few ulp), and the
    autograd Function (``conv2d_bias_shift`` when a gradient is needed) gives
    the same bits as the plain twin on the bias-free conv. Backward, against
    autograd through the conv and the unfused adds: the input's and the
    weight's gradients are the conv's own; the bias's the f32 sum of g over
    (B, H, W); the row's the sum over (H, W) in its dtype (f32: sums in
    another order)."""
    y0, bias, row, _ = _inputs(c, dtype, seed=c)
    row = row if with_row else None
    want = _unfused(y0, bias, row)
    tol = dict(atol=1e-5, rtol=1e-6) if dtype == torch.float32 else dict(atol=0.0, rtol=2 ** -8)

    y = y0.clone()
    got = bias_shift_plain(y, bias, row)
    assert got is y and got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got.float(), want.to(dtype).float(), **tol)

    x, weight, bias, row_all, ct = _conv_inputs(c, dtype, seed=c)
    row = row_all if with_row else None
    xa, wa, ba = x.clone().requires_grad_(), weight.clone().requires_grad_(), bias.clone().requires_grad_()
    ra = None if row is None else row.clone().requires_grad_()
    out = conv2d_bias_shift(xa, wa, ba, ra, *CONV)
    bare = torch.convolution(x.permute(0, 3, 1, 2), weight.to(dtype), None, *CONV[:3], False, (0, 0), 1)
    assert out.dtype == dtype and torch.equal(out.detach(), bias_shift_plain(bare, bias, row).permute(0, 2, 3, 1))
    out.backward(ct)

    xr, wr, br = x.clone().requires_grad_(), weight.clone().requires_grad_(), bias.clone().requires_grad_()
    rr = None if row is None else row.clone().requires_grad_()
    conv = torch.nn.functional.conv2d(xr.permute(0, 3, 1, 2), wr.to(dtype), None, *CONV)
    _unfused(conv, br, rr).permute(0, 2, 3, 1).backward(ct.float())
    assert xa.grad.dtype == dtype and wa.grad.dtype == torch.float32 and ba.grad.dtype == torch.float32
    torch.testing.assert_close(xa.grad, xr.grad, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(wa.grad, wr.grad, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(ba.grad, br.grad, atol=1e-4, rtol=1e-5)
    if row is not None:
        assert ra.grad.dtype == dtype
        torch.testing.assert_close(ra.grad.float(), rr.grad.to(dtype).float(), atol=1e-4, rtol=2 ** -7)


def test_backward_plain_sums_over_pixels_then_rows():
    _, _, _, ct = _inputs(7, torch.float32, seed=1, batch=3)
    dbias, drow = bias_shift_backward_plain(ct, torch.float32)
    assert dbias.shape == (7,) and drow.shape == (3, 7)
    torch.testing.assert_close(drow, ct.sum(dim=(2, 3)))
    torch.testing.assert_close(dbias, ct.sum(dim=(0, 2, 3)))
    assert bias_shift_backward_plain(ct)[1] is None


def test_function_gives_only_the_gradients_asked_for():
    """A frozen bias with a row that needs a gradient, and the reverse; a
    frozen input, and frozen conv weights (ANP's perturbation trains only
    what is merged into them)."""
    x, weight, bias, row, ct = _conv_inputs(16, torch.float32, seed=2)
    sums = ct.permute(0, 3, 1, 2)
    ra = row.clone().requires_grad_()
    conv2d_bias_shift(x, weight, bias, ra, *CONV).backward(ct)
    torch.testing.assert_close(ra.grad, sums.sum(dim=(2, 3)))
    ba = bias.clone().requires_grad_()
    conv2d_bias_shift(x, weight, ba, row, *CONV).backward(ct)
    torch.testing.assert_close(ba.grad, sums.sum(dim=(0, 2, 3)), atol=1e-4, rtol=1e-5)
    xa, wa = x.clone().requires_grad_(), weight.clone().requires_grad_()
    conv2d_bias_shift(xa, weight, bias, row, *CONV).backward(ct)
    conv2d_bias_shift(x, wa, bias, None, *CONV).backward(ct)
    xr, wr = x.clone().requires_grad_(), weight.clone().requires_grad_()
    torch.nn.functional.conv2d(xr.permute(0, 3, 1, 2), wr, None, *CONV).permute(0, 2, 3, 1).backward(ct)
    assert torch.equal(xa.grad, xr.grad) and torch.equal(wa.grad, wr.grad)


def test_conv2d_is_one_autograd_node_a_call():
    """With gradients, a ``Conv2d`` call records one node, whose inputs are
    the activation's node and the parameters' accumulators: no permute,
    cast or add of its own (the host pays one node a conv)."""
    conv = Conv2d(4, 8, 3, padding=1)
    x, _, _, row, _ = _conv_inputs(8, torch.bfloat16, seed=4)
    xa = (x.float().requires_grad_() * 1).to(torch.bfloat16)
    ra = row.clone().requires_grad_()
    out = conv(xa, row=ra)
    node = out.grad_fn
    assert type(node).__name__ == "_Conv2dBiasShiftBackward"
    nexts = [fn for fn, _ in node.next_functions]
    assert nexts[0] is xa.grad_fn
    assert [type(fn).__name__ for fn in nexts[1:4]] == ["AccumulateGrad"] * 3
    assert nexts[1].variable is conv.weight and nexts[2].variable is conv.bias and nexts[3].variable is ra


# (batch, hw, c): the cells' shapes (celebahq-256 at B=16 and 64: 256² x 128,
# 8² x 512, conv_out's 3; cifar10-32's measure at B=256), and small and odd ones
PLAN_SHAPES = [(16, 256 * 256, 128), (64, 256 * 256, 128), (16, 64, 512), (16, 256 * 256, 3), (256, 32 * 32, 128),
               (256, 4 * 4, 256), (2, 1, 512), (1, 7, 37), (3, 100, 1024), (1, 1, 640), (2, 5, 1)]


@pytest.mark.parametrize("elem_bytes,align", [(e, a) for e in (4, 2) for a in (16, 8, 4, 2) if a >= e])
@pytest.mark.parametrize("batch,hw,c", PLAN_SHAPES)
def test_bias_shift_launch_plan(batch, hw, c, elem_bytes, align):
    """The pack is the widest of 1, 2, 4, 8 that is at most 16 bytes and
    divides C and the alignment; a block is whole pixel rows of pack columns,
    as many as fit in 256 threads (at least one), at most 1024 threads; the
    forward's grid covers the pixels exactly (no block beyond them); the
    backward's chunks are whole block tiles that cover the pixels, the longest
    that give at least 528 blocks, and its shared memory fits 48 KB."""
    plan = bias_shift_plan(batch, hw, c, elem_bytes, align)
    ok = [v for v in (1, 2, 4, 8) if v * elem_bytes <= BS.PACK_BYTES and c % v == 0 and align % (v * elem_bytes) == 0]
    assert plan.vec == max(ok)
    cols = c // plan.vec
    assert plan.threads == cols * plan.rows and plan.threads <= BS.MAX_THREADS
    assert plan.rows == max(1, BS.BLOCK_THREADS // cols)
    tile = BS.UNROLL * plan.rows
    assert plan.blocks * tile >= hw > (plan.blocks - 1) * tile
    assert plan.chunk_rows % tile == 0
    assert plan.chunks * plan.chunk_rows >= hw > (plan.chunks - 1) * plan.chunk_rows
    want = -(-BS.FILL_BLOCKS // batch)  # chunks a batch row needs to fill the card
    assert (plan.chunk_rows + tile) * want > hw  # a tile more a chunk would leave too few blocks
    if plan.chunk_rows > tile:
        assert plan.chunk_rows * want <= hw and batch * plan.chunks >= BS.FILL_BLOCKS
    assert plan.threads * plan.vec * 4 <= 48 * 1024


def test_bias_shift_launch_plan_packs_the_cells_16_bytes_wide():
    assert bias_shift_plan(16, 256 * 256, 128, 2, 16).vec == 8
    assert bias_shift_plan(256, 32 * 32, 128, 4, 16).vec == 4
    assert bias_shift_plan(16, 256 * 256, 3, 2, 16).vec == 1


def test_bias_shift_launch_plan_refuses_more_packs_than_threads():
    with pytest.raises(ValueError, match="at most 1024 packs"):
        bias_shift_plan(1, 4, 1031, 4, 16)


def test_wrappers_refuse_what_the_kernels_do_not_take_and_count_nothing_on_the_cpu():
    ops.reset_launch_counts()
    y, bias, row, ct = _inputs(8, torch.bfloat16, seed=3)
    with pytest.raises(ValueError, match="bias must be a \\[8\\] float32"):
        bias_shift(y, bias.to(torch.bfloat16))
    with pytest.raises(ValueError, match="bias must be a \\[8\\] float32"):
        bias_shift(y, bias[:4])
    with pytest.raises(ValueError, match="row must be a \\[2, 8\\]"):
        bias_shift(y, bias, row.float())
    with pytest.raises(ValueError, match="row must be a \\[2, 8\\]"):
        bias_shift(y, bias, row[:1])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bias_shift(y.half(), bias)
    bias_shift(y, bias, row)
    with pytest.raises(ValueError, match="not differentiable"):
        bias_shift(y.float().requires_grad_() * 1, bias, None)
    x, weight, bias, row, ct = _conv_inputs(8, torch.bfloat16, seed=3)
    conv2d_bias_shift(x.requires_grad_(), weight.requires_grad_(), bias, row.requires_grad_(), *CONV).backward(ct)
    assert ops.launch_counts() == {"groupnorm_silu": 0, "groupnorm_silu_backward": 0, "attention": 0,
                                   "bias_shift": 0, "bias_shift_backward": 0, "vq_nearest": 0}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_conv2d_with_a_row_is_nn_conv2d_plus_the_broadcast_add(dtype):
    """The port's NHWC ``Conv2d`` (conv without bias, then the shift) against
    ``nn.Conv2d`` with its bias, plus the row; gradients of every input,
    weight, bias and row (f32 on the CPU: sums in another order)."""
    torch.manual_seed(0)
    ref = nn.Conv2d(16, 24, 3, padding=1)
    conv = Conv2d(16, 24, 3, padding=1)
    conv.load_state_dict(ref.state_dict())
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 6, 6, 16, generator=g).to(dtype)
    row = torch.randn(2, 24, generator=g).to(dtype).requires_grad_()
    xa = x.clone().requires_grad_()
    out = conv(xa, row=row)
    assert out.shape == (2, 6, 6, 24) and out.dtype == dtype and out.is_contiguous()
    ref_x = x.float().requires_grad_()
    ref_row = row.detach().float().requires_grad_()
    want = ref(ref_x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) + ref_row[:, None, None, :]
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=0.05, rtol=0.02)
    torch.testing.assert_close(out.float(), want, **tol)
    ct = torch.randn(out.shape, generator=g)
    out.backward(ct.to(dtype))
    want.backward(ct)
    for got, exp in ((xa.grad, ref_x.grad), (conv.weight.grad, ref.weight.grad), (conv.bias.grad, ref.bias.grad),
                     (row.grad, ref_row.grad)):
        torch.testing.assert_close(got.float(), exp, **(dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32
                                                        else dict(atol=0.3, rtol=0.05)))
