"""Self-attention forward: a CUDA kernel for Hopper and its plain twin, with
a backward in plain PyTorch.

Port of ``baddiffusion_tpu/ops/attention.py``. The kernel,
``csrc/attention.cu``, replaces the Pallas TPU kernel
``_forward_pallas``/``_kernel``: softmax(q·kᵀ·scale)·v per (batch, head) over
``[B, H, T, D]``, with scores, softmax and the weighted sum in f32 and no
``[T, T]`` tensor in memory. Its source note says what bounds it (launch
latency at the UNet's shapes) and how the online-softmax design answers that.
Envelope, as in the TPU module: T ≤ 1024, D a multiple of 8 in [8, 512].

``attention`` is differentiable (``_Attention``): the kernel runs the
forward, and the backward recomputes the f32 softmax and applies the
attention VJP in plain PyTorch, as the JAX ``custom_vjp`` leaves its backward
to XLA; the TPU package has no backward kernel to port.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor goes to the
kernel, or the wrapper raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from baddiffusion_tpu_torch.ops import _build

MAX_T = 1024
MIN_D, MAX_D = 8, 512


def _probs_f32(q, k, scale: float) -> torch.Tensor:
    return torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, dim=-1)


def attention_plain(q, k, v, scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 scores, f32 softmax, f32
    weighted sum, cast to q's dtype."""
    return torch.matmul(_probs_f32(q, k, scale), v.float()).to(q.dtype)


def attention_backward_plain(q, k, v, scale: float, grad_out):
    """(dq, dk, dv) of ``attention_plain`` at ``grad_out``, in f32 with the
    softmax recomputed, cast to the inputs' dtype."""
    p = _probs_f32(q, k, scale)
    g = grad_out.float()
    dv = torch.matmul(p.transpose(-1, -2), g)
    dp = torch.matmul(g, v.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("attention").bd_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_inputs(q, k, v) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"attention takes CPU or CUDA tensors, got {q.device}")
    if q.dim() != 4:
        raise ValueError(f"attention expects [B, H, T, D], got shape {tuple(q.shape)}")
    _, _, t, d = q.shape
    if not (1 <= t <= MAX_T and MIN_D <= d <= MAX_D and d % 8 == 0):
        raise ValueError(f"attention kernel envelope is T <= {MAX_T}, D in [{MIN_D}, {MAX_D}] with D % 8 == 0; got T={t}, D={d}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attention kernel takes float32 or bfloat16, got {q.dtype}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.shape != q.shape or a.dtype != q.dtype or a.device != q.device:
            raise ValueError(f"attention {name} must match q: {tuple(q.shape)} {q.dtype} on {q.device}")
        if not a.is_contiguous():
            raise ValueError(f"attention kernel needs contiguous [B, H, T, D] inputs; {name} has strides {a.stride()}")


def _forward(q, k, v, scale: float) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    _check_cuda_inputs(q, k, v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if q.numel() == 0:
        return out
    b, h, t, d = q.shape
    with torch.cuda.device(q.device):
        rc = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, t, d, float(scale), _build.DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {rc} at shape {tuple(q.shape)} {q.dtype}")
    attention.launches += 1
    return out


class _Attention(torch.autograd.Function):
    """Kernel forward, plain f32 backward (``attention_backward_plain``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        return (*attention_backward_plain(q, k, v, ctx.scale, grad_out), None)


def attention(q, k, v, scale: float) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v over ``[B, H, T, D]``. CPU → plain version; CUDA →
    the kernel (counted in ``attention.launches``), or raise. Differentiable
    through ``attention_backward_plain``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Attention.apply(q, k, v, scale)
    return _forward(q, k, v, scale)


attention.launches = 0
