"""Fused GroupNorm + SiLU, forward (K1) and backward (K2): CUDA kernels for
Hopper and their plain twins.

Port of ``baddiffusion_tpu/ops/groupnorm.py``. K1, ``csrc/groupnorm_silu.cu``,
replaces the Pallas TPU kernel ``_forward_pallas``/``_fwd_kernel``; K2,
``csrc/groupnorm_silu_bwd.cu``, replaces ``_backward_pallas``/``_bwd_kernel``.
Each source note says what bounds its kernel on the card (bytes) and how its
design answers that.

Layout is the JAX package's: ``x`` is a contiguous NHWC tensor ``[B, H, W, C]``
(an NCHW tensor in ``torch.channels_last`` memory, viewed as NHWC). Statistics
are single-pass f32, var = max(E[x²] − E[x]², 0), never two-pass like
``torch.nn.GroupNorm``. The affine γ/β are f32 whatever x's dtype, as in the
TPU kernel; the output and dx are in x's dtype, dγ/dβ in f32.

``groupnorm_silu`` is differentiable: under autograd it runs K1 with its
``[B, G]`` mean/rstd saved and K2 in the backward (``_GroupNormSiLU``), the
counterpart of the JAX ``custom_vjp``.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor goes to the
kernel, or the wrapper raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from baddiffusion_tpu_torch.ops import _build

# K2's thread block owns at least one channel pack per thread (csrc note)
MAX_GROUP_WIDTH_BWD = 256


def _check_groups(c: int, num_groups: int) -> None:
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by num_groups {num_groups}")


def groupnorm_stats_plain(x: torch.Tensor, num_groups: int, eps: float):
    """Single-pass clamped f32 statistics of NHWC ``x``: (mean, rstd), each
    ``[B, G]`` f32, as K1 saves them."""
    b, c = x.shape[0], x.shape[-1]
    _check_groups(c, num_groups)
    grouped = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = grouped.mean(dim=(1, 3))
    mean_sq = grouped.square().mean(dim=(1, 3))
    var = torch.clamp(mean_sq - mean.square(), min=0.0)
    return mean, torch.rsqrt(var + eps)


def _xhat_f32(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor) -> torch.Tensor:
    b, c = x.shape[0], x.shape[-1]
    g = mean.shape[-1]
    grouped = x.float().reshape(b, -1, g, c // g)
    return ((grouped - mean[:, None, :, None]) * rstd[:, None, :, None]).reshape(x.shape)


def _normalize_f32(x, weight, bias, num_groups: int, eps: float) -> torch.Tensor:
    """GroupNorm over the last (channel) axis in f32, affine included; f32."""
    mean, rstd = groupnorm_stats_plain(x, num_groups, eps)
    return _xhat_f32(x, mean, rstd) * weight.float() + bias.float()


def groupnorm_plain(x, weight, bias, num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm alone (no SiLU), in x's dtype — the form ``AttentionBlock``
    and the ``scale_shift`` resnet norm use (models/resnet.py ``GroupNorm``)."""
    return _normalize_f32(x, weight, bias, num_groups, eps).to(x.dtype)


def groupnorm_silu_plain(x, weight, bias, num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of K1: the same single-pass f32 math, SiLU in
    f32, then cast to x's dtype."""
    return F.silu(_normalize_f32(x, weight, bias, num_groups, eps)).to(x.dtype)


def groupnorm_silu_backward_plain(x, weight, bias, mean, rstd, grad_out, num_groups: int):
    """Plain PyTorch version of K2, from the formulas of the JAX module:
    returns (dx in x's dtype, dγ f32, dβ f32). ``mean``/``rstd`` are the
    forward's ``[B, G]`` statistics (eps is already inside rstd)."""
    b, c = x.shape[0], x.shape[-1]
    if mean.shape != (b, num_groups) or rstd.shape != (b, num_groups):
        raise ValueError(f"mean/rstd must be [{b}, {num_groups}], got {tuple(mean.shape)}, {tuple(rstd.shape)}")
    xhat = _xhat_f32(x, mean, rstd).reshape(b, -1, c)
    gamma = weight.float()
    y = xhat * gamma + bias.float()
    s = torch.sigmoid(y)
    dy = grad_out.float().reshape(b, -1, c) * (s * (1.0 + y * (1.0 - s)))
    dbeta = dy.sum(dim=(0, 1))
    dgamma = (dy * xhat).sum(dim=(0, 1))
    dxhat = dy * gamma

    def group_mean(t):  # [b, hw, c] -> per-(row, group) mean, broadcast back over [b, hw, G, c/G]
        return t.reshape(b, -1, num_groups, c // num_groups).mean(dim=(1, 3))[:, None, :, None]

    shape4 = (b, -1, num_groups, c // num_groups)
    dx = rstd[:, None, :, None] * (
        dxhat.reshape(shape4) - group_mean(dxhat) - xhat.reshape(shape4) * group_mean(dxhat * xhat)
    )
    return dx.reshape(x.shape).to(x.dtype), dgamma, dbeta


@functools.lru_cache(maxsize=None)
def _forward_kernel():
    fn = _build.load("groupnorm_silu").bd_groupnorm_silu_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _backward_kernel():
    fn = _build.load("groupnorm_silu_bwd").bd_groupnorm_silu_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_activation(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.shape != like.shape or t.dtype != like.dtype or t.device != like.device:
        raise ValueError(f"groupnorm_silu {name} must match x: {tuple(like.shape)} {like.dtype} on {like.device}")
    if not t.is_contiguous():
        raise ValueError(
            f"groupnorm_silu kernel needs a contiguous NHWC {name} (NCHW in channels_last "
            f"memory); got strides {t.stride()} for shape {tuple(t.shape)}"
        )


def _check_f32_vector(name: str, p: torch.Tensor, n: int, device) -> None:
    if p.shape != (n,) or p.dtype != torch.float32 or p.device != device or not p.is_contiguous():
        raise ValueError(
            f"groupnorm_silu {name} must be a contiguous [{n}] float32 tensor on {device}, "
            f"got {tuple(p.shape)} {p.dtype} on {p.device}"
        )


def _check_cuda_inputs(x, weight, bias, num_groups: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"groupnorm_silu takes CPU or CUDA tensors, got {x.device}")
    if x.dim() != 4:
        raise ValueError(f"groupnorm_silu expects NHWC [B, H, W, C], got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"groupnorm_silu kernel takes float32 or bfloat16, got {x.dtype}")
    _check_cuda_activation("x", x, x)
    c = x.shape[-1]
    _check_groups(c, num_groups)
    _check_f32_vector("weight", weight, c, x.device)
    _check_f32_vector("bias", bias, c, x.device)


def _launch_forward(x, weight, bias, num_groups: int, eps: float, save_stats: bool):
    _check_cuda_inputs(x, weight, bias, num_groups)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    b, h, w, c = x.shape
    stats = [torch.empty(b, num_groups, dtype=torch.float32, device=x.device) for _ in range(2)] if save_stats else [None, None]
    if x.numel() == 0:
        return out, *stats
    with torch.cuda.device(x.device):
        rc = _forward_kernel()(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            *(s.data_ptr() if s is not None else None for s in stats),
            b, h * w, c, num_groups, float(eps), _build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"groupnorm_silu kernel launch failed: cudaError {rc} at shape {tuple(x.shape)} {x.dtype}")
    groupnorm_silu.launches += 1
    return out, *stats


def groupnorm_silu_forward(x, weight, bias, num_groups: int, eps: float = 1e-5):
    """K1 with its statistics: (out in x's dtype, mean ``[B, G]`` f32, rstd
    ``[B, G]`` f32). CPU → plain version; CUDA → K1 (counted in
    ``groupnorm_silu.launches``), or raise."""
    if x.device.type == "cpu":
        return groupnorm_silu_plain(x, weight, bias, num_groups, eps), *groupnorm_stats_plain(x, num_groups, eps)
    return _launch_forward(x, weight, bias, num_groups, eps, save_stats=True)


def groupnorm_silu_backward(x, weight, bias, mean, rstd, grad_out, num_groups: int):
    """K2: (dx in x's dtype, dγ f32, dβ f32) from the forward's input and
    statistics and the output cotangent. CPU → plain version; CUDA → K2
    (counted in ``groupnorm_silu_backward.launches``), or raise."""
    if x.device.type == "cpu":
        return groupnorm_silu_backward_plain(x, weight, bias, mean, rstd, grad_out, num_groups)
    _check_cuda_inputs(x, weight, bias, num_groups)
    _check_cuda_activation("grad_out", grad_out, x)
    b, h, w, c = x.shape
    for name, s in (("mean", mean), ("rstd", rstd)):
        if s.shape != (b, num_groups) or s.dtype != torch.float32 or s.device != x.device or not s.is_contiguous():
            raise ValueError(f"groupnorm_silu {name} must be a contiguous [{b}, {num_groups}] float32 tensor on {x.device}")
    if c // num_groups > MAX_GROUP_WIDTH_BWD:
        raise ValueError(f"groupnorm_silu backward kernel takes C/G <= {MAX_GROUP_WIDTH_BWD}, got {c // num_groups}")
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel() == 0:
        return dx, torch.zeros_like(weight), torch.zeros_like(bias)
    dgamma_dbeta = torch.empty(2 * c, dtype=torch.float32, device=x.device)
    partial = torch.empty(b, 2 * c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _backward_kernel()(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            grad_out.data_ptr(), dx.data_ptr(), partial.data_ptr(), dgamma_dbeta.data_ptr(),
            b, h * w, c, num_groups, _build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"groupnorm_silu backward kernel launch failed: cudaError {rc} at shape {tuple(x.shape)} {x.dtype}"
        )
    groupnorm_silu_backward.launches += 1
    return dx, dgamma_dbeta[:c], dgamma_dbeta[c:]


groupnorm_silu_backward.launches = 0


class _GroupNormSiLU(torch.autograd.Function):
    """K1 with saved statistics forward, K2 backward (the JAX ``custom_vjp``
    ``_fwd``/``_bwd``); dγ/dβ come back in the parameters' dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps):
        out, mean, rstd = groupnorm_silu_forward(x, weight, bias, num_groups, eps)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        ctx.num_groups = num_groups
        return out

    @staticmethod
    def backward(ctx, grad_out):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = groupnorm_silu_backward(x, weight, bias, mean, rstd, grad_out.contiguous(), ctx.num_groups)
        return dx, dgamma.to(weight.dtype), dbeta.to(bias.dtype), None, None


def groupnorm_silu(x, weight, bias, num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm followed by SiLU over NHWC ``x``; weight and bias are f32
    ``[C]``. CPU → plain version; CUDA → K1 (counted in
    ``groupnorm_silu.launches``), or raise. Differentiable: when a gradient
    is needed the backward is K2 on the card and its plain twin on the CPU."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad):
        return _GroupNormSiLU.apply(x, weight, bias, num_groups, eps)
    if x.device.type == "cpu":
        return groupnorm_silu_plain(x, weight, bias, num_groups, eps)
    return _launch_forward(x, weight, bias, num_groups, eps, save_stats=False)[0]


groupnorm_silu.launches = 0
