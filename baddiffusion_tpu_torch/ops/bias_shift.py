"""Per-channel shift of a convolution's output: the conv's bias, and a
resnet's time embedding, added in one pass in place; their gradients summed
in one deterministic reduce. A CUDA kernel pair for Hopper and its plain twin.

Replaces no Pallas kernel: on the TPU, XLA fuses the bias add into the
convolution. Every ``Conv2d`` of the port (models/resnet.py) goes through
``conv2d_bias_shift``: cuDNN runs the conv without its bias, then
``bias_shift`` adds it; ``csrc/bias_shift.cu`` says what bounds the pair
(bytes) and how its design answers that. When a gradient is needed one
autograd ``Function`` carries the conv and the shift, so a conv costs the
host one autograd node, as few as the conv alone would. The launch plan
(pack width, threads, grid, the backward's chunks) is chosen on the host from
the shape alone, ``bias_shift_plan``, which the CPU tests hold to its rules.

Layout: ``y`` is the conv's ``[B, C, H, W]`` output in ``torch.channels_last``
memory, as cuDNN returns it for the port's NHWC activations: a contiguous
NHWC tensor in memory. ``bias`` is the f32 ``[C]`` parameter; ``row`` (or
None) a ``[B, C]`` shift in y's dtype. ``y + (bias + row)`` is summed in f32
and rounded once to y's dtype. The gradients: ``g`` for y itself, the f32
sums of g over H·W for each (b, c) for the row (rounded to its dtype), and
their sum over b for the bias (f32).

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor goes to the
kernel, or the wrapper raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from baddiffusion_tpu_torch.ops import _build

PACK_BYTES = 16  # the widest pack: one 16-byte load a thread
MAX_THREADS = 1024  # the kernels' launch bound: at most that many pack columns
BLOCK_THREADS = 256  # a block's threads, where C / vec leaves room for several pixel rows
UNROLL = 4  # pixel rows a thread loads before it uses them (csrc ``kUnroll``)
FILL_BLOCKS = 4 * 132  # the backward's first kernel: four blocks an SM


class ShiftPlan(NamedTuple):
    """How the pair runs one shape: packs of ``vec`` elements, ``threads``
    per block as ``rows`` pixel rows of C / vec pack columns; the forward's
    ``blocks`` along each batch row's pixels; the backward's ``chunks`` of
    ``chunk_rows`` pixels a batch row, one block each."""

    vec: int
    threads: int
    rows: int
    blocks: int
    chunks: int
    chunk_rows: int


@functools.lru_cache(maxsize=1024)
def bias_shift_plan(batch: int, hw: int, c: int, elem_bytes: int, align: int) -> ShiftPlan:
    """The launch plan for y (or the cotangent) ``[batch, hw, c]`` of
    ``elem_bytes`` elements whose data is aligned to ``align`` bytes (a power
    of 2, at most 16). Packs are the widest that divide C and the alignment;
    a block holds as many whole pixel rows of pack columns as fit in
    ``BLOCK_THREADS`` (at least one); the forward's grid covers the pixels at
    ``UNROLL`` rows a thread; the backward splits each batch row into
    chunks of the most whole block tiles that still give at least
    ``FILL_BLOCKS`` blocks in all (one tile a chunk where none does). Cached: the host pays one lookup a call."""
    vec = max(v for v in (1, 2, 4, 8) if v * elem_bytes <= PACK_BYTES and c % v == 0 and align % (v * elem_bytes) == 0)
    cols = c // vec
    if cols > MAX_THREADS:
        raise ValueError(f"bias_shift kernel takes at most {MAX_THREADS} packs a pixel; got C = {c} in packs of {vec}")
    rows = max(1, BLOCK_THREADS // cols)
    tile = UNROLL * rows
    want = -(-FILL_BLOCKS // batch)
    chunk_rows = tile * max(1, hw // (want * tile))
    return ShiftPlan(vec, cols * rows, rows, -(-hw // tile), -(-hw // chunk_rows), chunk_rows)


@functools.lru_cache(maxsize=None)
def _forward_kernel():
    fn = _build.load("bias_shift").bd_bias_shift_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _backward_kernel():
    fn = _build.load("bias_shift").bd_bias_shift_bwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(y: torch.Tensor, bias: torch.Tensor, row: Optional[torch.Tensor]) -> None:
    """Raise unless the forward takes these tensors: the plain version any
    layout of y, the kernel y in channels_last memory."""
    shape, dev = y.shape, y.get_device()
    if len(shape) != 4 or y.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"bias_shift takes a float32 or bfloat16 [B, C, H, W] y, got {tuple(shape)} {y.dtype}")
    if (bias.dtype is not torch.float32 or bias.shape != shape[1:2] or bias.get_device() != dev
            or not bias.is_contiguous()):
        raise ValueError(f"bias_shift bias must be a [{shape[1]}] float32 tensor, contiguous, on {y.device}; "
                         f"got {tuple(bias.shape)} {bias.dtype} on {bias.device}")
    if row is not None and (row.dtype is not y.dtype or row.shape != shape[:2] or row.get_device() != dev
                            or not row.is_contiguous()):
        raise ValueError(f"bias_shift row must be a [{shape[0]}, {shape[1]}] {y.dtype} tensor, contiguous, on "
                         f"{y.device}; got {tuple(row.shape)} {row.dtype} on {row.device}")
    if dev >= 0:
        _check_channels_last("y", y)


def _check_channels_last(name: str, t: torch.Tensor) -> None:
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"bias_shift kernel needs {name} in channels_last memory (a contiguous NHWC tensor); "
                         f"got strides {t.stride()} for shape {tuple(t.shape)}")


def bias_shift_plain(y: torch.Tensor, bias: torch.Tensor, row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: ``y + (bias + row)`` in
    f32, rounded once to y's dtype, written into y; returns y."""
    _check(y, bias, row)
    shift = bias.view(1, -1, 1, 1)
    if row is not None:
        shift = shift + row.float()[:, :, None, None]
    return y.copy_(y.float() + shift)


def bias_shift_backward_plain(g: torch.Tensor, row_dtype: Optional[torch.dtype] = None):
    """Plain PyTorch version of the backward kernels: (the bias's gradient,
    f32 ``[C]``; the row's, ``[B, C]`` in ``row_dtype``, or None without a
    row) from the ``[B, C, H, W]`` cotangent ``g``."""
    sums = g.float().sum(dim=(2, 3))
    return sums.sum(dim=0), None if row_dtype is None else sums.to(row_dtype)


def _launch_forward(y: torch.Tensor, bias: torch.Tensor, row: Optional[torch.Tensor]) -> torch.Tensor:
    b, c, h, w = y.shape
    if y.numel() == 0:
        return y
    ptr = y.data_ptr()
    plan = bias_shift_plan(b, h * w, c, y.element_size(), min(16, ptr & -ptr))
    dev = y.get_device()
    rc = _forward_kernel()(
        ptr, bias.data_ptr(), None if row is None else row.data_ptr(), b, h * w, c, plan.vec, plan.threads,
        plan.blocks, _build.DTYPE_CODES[y.dtype], dev, _build.current_stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"bias_shift kernel launch failed: cudaError {rc} at shape {tuple(y.shape)} {y.dtype}")
    bias_shift.launches += 1
    return y


def bias_shift(y: torch.Tensor, bias: torch.Tensor, row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y += bias (+ row)`` per channel, in place, summed in f32 and rounded
    once; returns y. ``y``: a conv's ``[B, C, H, W]`` output (on the card in
    channels_last memory); ``bias``: f32 ``[C]``; ``row``: ``[B, C]`` in y's
    dtype, or None. CPU → plain version; CUDA → the forward kernel (counted
    in ``bias_shift.launches``), or raise. Not differentiable: a forward
    that needs gradients goes through ``conv2d_bias_shift``."""
    if torch.is_grad_enabled() and (y.requires_grad or bias.requires_grad or (row is not None and row.requires_grad)):
        raise ValueError("bias_shift is not differentiable; conv2d_bias_shift carries the shift's gradients")
    if not y.is_cuda:
        return bias_shift_plain(y, bias, row)
    _check(y, bias, row)
    return _launch_forward(y, bias, row)


bias_shift.launches = 0


def bias_shift_backward(g: torch.Tensor, row_dtype: Optional[torch.dtype] = None):
    """The backward kernels: (the bias's gradient, f32 ``[C]``; the row's,
    ``[B, C]`` in ``row_dtype``, or None) from the ``[B, C, H, W]`` cotangent
    in channels_last memory. CPU → plain version; CUDA → the kernels (counted
    in ``bias_shift_backward.launches``), or raise."""
    if not g.is_cuda:
        return bias_shift_backward_plain(g, row_dtype)
    if g.dim() != 4 or g.dtype not in _build.DTYPE_CODES:
        raise ValueError(
            f"bias_shift_backward takes a float32 or bfloat16 [B, C, H, W] g, got {tuple(g.shape)} {g.dtype}"
        )
    _check_channels_last("g", g)
    if row_dtype not in (None, g.dtype):
        raise ValueError(f"bias_shift_backward row dtype must be g's ({g.dtype}), got {row_dtype}")
    b, c, h, w = g.shape
    dbias = torch.empty(c, dtype=torch.float32, device=g.device)
    drow = None if row_dtype is None else torch.empty(b, c, dtype=g.dtype, device=g.device)
    if g.numel() == 0:
        return dbias.zero_(), None if drow is None else drow.zero_()
    ptr = g.data_ptr()
    plan = bias_shift_plan(b, h * w, c, g.element_size(), min(16, ptr & -ptr))
    partial = torch.empty(b * plan.chunks * c, dtype=torch.float32, device=g.device)
    dev = g.get_device()
    rc = _backward_kernel()(
        ptr, partial.data_ptr(), dbias.data_ptr(), None if drow is None else drow.data_ptr(), b, h * w, c,
        plan.vec, plan.threads, plan.chunks, plan.chunk_rows, _build.DTYPE_CODES[g.dtype], dev,
        _build.current_stream(dev),
    )
    if rc != 0:
        raise RuntimeError(
            f"bias_shift backward kernel launch failed: cudaError {rc} at shape {tuple(g.shape)} {g.dtype}"
        )
    bias_shift_backward.launches += 1
    return dbias, drow


bias_shift_backward.launches = 0

_NO_OUTPUT_PADDING = (0, 0)


class _Conv2dBiasShift(torch.autograd.Function):
    """The conv without its bias, then the shift (forward); backward:
    cuDNN's data and weight gradients where needed (``convolution_backward``,
    as autograd would call it) and the reduce for the bias's and the row's.
    One autograd node a conv: it takes the NHWC activation and the
    parameters as they are, and does the layout views and the weight's cast
    to the activation's dtype itself."""

    @staticmethod
    def forward(ctx, x, weight, bias, row, stride, padding, dilation, groups):
        xc = x.permute(0, 3, 1, 2)
        w = weight.to(x.dtype)
        y = bias_shift(torch.convolution(xc, w, None, stride, padding, dilation, False, _NO_OUTPUT_PADDING, groups),
                       bias, row)
        ctx.save_for_backward(xc, w)
        ctx.conv = (stride, padding, dilation, groups)
        ctx.weight_dtype = weight.dtype
        ctx.row_dtype = None if row is None else row.dtype
        return y.permute(0, 2, 3, 1)

    @staticmethod
    def backward(ctx, g):
        need_x, need_w, need_bias, need_row = ctx.needs_input_grad[:4]
        gc = g.permute(0, 3, 1, 2)
        dx = dw = dbias = drow = None
        if need_bias or need_row:
            if gc.is_cuda:
                gc = gc.contiguous(memory_format=torch.channels_last)
            dbias, drow = bias_shift_backward(gc, ctx.row_dtype if need_row else None)
        if need_x or need_w:
            xc, w = ctx.saved_tensors
            stride, padding, dilation, groups = ctx.conv
            dx, dw, _ = torch.ops.aten.convolution_backward.default(
                gc, xc, w, None, stride, padding, dilation, False, _NO_OUTPUT_PADDING, groups, [need_x, need_w, False]
            )
            dx = None if dx is None else dx.permute(0, 2, 3, 1)
            dw = None if dw is None else dw.to(ctx.weight_dtype)
        return dx, dw, dbias if need_bias else None, drow, None, None, None, None


def conv2d_bias_shift(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, row: Optional[torch.Tensor],
                      stride, padding, dilation, groups: int) -> torch.Tensor:
    """A 2-D convolution of the NHWC activation ``x`` (weight OIHW, cast to
    x's dtype; zero padding) without its bias, then ``bias_shift`` of its
    output by the f32 ``bias`` and ``row`` (``[B, C_out]`` in x's dtype, or
    None); returns the NHWC result. Differentiable: when a gradient is
    needed one autograd node carries the conv's and the shift's backward (the
    reduce kernels on the card, their plain twin on the CPU)."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad
                                    or (row is not None and row.requires_grad)):
        return _Conv2dBiasShift.apply(x, weight, bias, row, stride, padding, dilation, groups)
    y = torch.convolution(x.permute(0, 3, 1, 2), weight.to(x.dtype), None, stride, padding, dilation, False,
                          _NO_OUTPUT_PADDING, groups)
    return bias_shift(y, bias, row).permute(0, 2, 3, 1)
