"""Self-attention forward: a CUDA kernel for Hopper and its plain twin.

Port of ``baddiffusion_tpu/ops/attention.py``. The kernel,
``csrc/attention.cu``, replaces the Pallas TPU kernel
``_forward_pallas``/``_kernel``: softmax(q·kᵀ·scale)·v per (batch, head) over
``[B, H, T, D]``, with scores, softmax and the weighted sum in f32 and no
``[T, T]`` tensor in memory. Its source note says what bounds it (launch
latency at the UNet's shapes) and how the online-softmax design answers that.
Envelope, as in the TPU module: T ≤ 1024, D a multiple of 8 in [8, 512].

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


def attention_plain(q, k, v, scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 scores, f32 softmax, f32
    weighted sum, cast to q's dtype."""
    q32, k32, v32 = q.float(), k.float(), v.float()
    probs = torch.softmax(torch.matmul(q32, k32.transpose(-1, -2)) * scale, dim=-1)
    return torch.matmul(probs, v32).to(q.dtype)


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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("attention kernel is forward-only: run under torch.no_grad()")


def attention(q, k, v, scale: float) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v over ``[B, H, T, D]``. CPU → plain version; CUDA →
    the kernel (counted in ``attention.launches``), or raise."""
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


attention.launches = 0
