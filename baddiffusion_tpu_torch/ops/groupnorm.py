"""Fused GroupNorm + SiLU forward: a CUDA kernel for Hopper and its plain twin.

Port of ``baddiffusion_tpu/ops/groupnorm.py`` (forward only; the hand-written
backward comes with the training path). The kernel, ``csrc/groupnorm_silu.cu``,
replaces the Pallas TPU kernel ``_forward_pallas``/``_fwd_kernel``; its source
note says what bounds it on the card (bytes) and how its design answers that.

Layout is the JAX package's: ``x`` is a contiguous NHWC tensor ``[B, H, W, C]``
(an NCHW tensor in ``torch.channels_last`` memory, viewed as NHWC). Statistics
are single-pass f32, var = max(E[x²] − E[x]², 0), never two-pass like
``torch.nn.GroupNorm``.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor goes to the
kernel, or the wrapper raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from baddiffusion_tpu_torch.ops import _build


def _normalize_f32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float) -> torch.Tensor:
    """GroupNorm over the last (channel) axis in f32 with single-pass clamped
    statistics over every other non-batch axis; returns f32."""
    b, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by num_groups {num_groups}")
    grouped = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = grouped.mean(dim=(1, 3), keepdim=True)
    mean_sq = grouped.square().mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(mean_sq - mean.square(), min=0.0)
    normed = ((grouped - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return normed * weight.float() + bias.float()


def groupnorm_plain(x, weight, bias, num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm alone (no SiLU), in x's dtype — the form ``AttentionBlock``
    and the ``scale_shift`` resnet norm use (models/resnet.py ``GroupNorm``)."""
    return _normalize_f32(x, weight, bias, num_groups, eps).to(x.dtype)


def groupnorm_silu_plain(x, weight, bias, num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same single-pass f32 math,
    SiLU in f32, then cast to x's dtype."""
    return F.silu(_normalize_f32(x, weight, bias, num_groups, eps)).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("groupnorm_silu").bd_groupnorm_silu_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_inputs(x, weight, bias, num_groups: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"groupnorm_silu takes CPU or CUDA tensors, got {x.device}")
    if x.dim() != 4:
        raise ValueError(f"groupnorm_silu expects NHWC [B, H, W, C], got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"groupnorm_silu kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(
            "groupnorm_silu kernel needs a contiguous NHWC tensor (NCHW in channels_last "
            f"memory); got strides {x.stride()} for shape {tuple(x.shape)}"
        )
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by num_groups {num_groups}")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.shape != (c,) or p.dtype != x.dtype or p.device != x.device or not p.is_contiguous():
            raise ValueError(
                f"groupnorm_silu {name} must be a contiguous [{c}] {x.dtype} tensor on {x.device}, "
                f"got {tuple(p.shape)} {p.dtype} on {p.device}"
            )
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad):
        raise NotImplementedError("groupnorm_silu kernel is forward-only: run under torch.no_grad()")


def groupnorm_silu(x, weight, bias, num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm followed by SiLU over NHWC ``x``; weight and bias are ``[C]``
    in x's dtype. CPU → plain version; CUDA → the kernel (counted in
    ``groupnorm_silu.launches``), or raise."""
    if x.device.type == "cpu":
        return groupnorm_silu_plain(x, weight, bias, num_groups, eps)
    _check_cuda_inputs(x, weight, bias, num_groups)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel() == 0:
        return out
    b, h, w, c = x.shape
    with torch.cuda.device(x.device):
        rc = _kernel()(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, h * w, c, num_groups, float(eps), _build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"groupnorm_silu kernel launch failed: cudaError {rc} at shape {tuple(x.shape)} {x.dtype}")
    groupnorm_silu.launches += 1
    return out


groupnorm_silu.launches = 0
