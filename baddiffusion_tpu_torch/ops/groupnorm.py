"""Fused GroupNorm + SiLU, forward (K1) and backward (K2): CUDA kernels for
Hopper and their plain twins.

Port of ``baddiffusion_tpu/ops/groupnorm.py``. K1, ``csrc/groupnorm_silu.cu``,
replaces the Pallas TPU kernel ``_forward_pallas``/``_fwd_kernel``; K2,
``csrc/groupnorm_silu_bwd.cu``, replaces ``_backward_pallas``/``_bwd_kernel``.
Each source note says what bounds its kernel on the card (bytes) and how its
design answers that. Each kernel's launch plan (slab width, pack width,
threads, shared memory, staging) is chosen on the host by one rule,
``groupnorm_silu_plan`` for K1 and ``groupnorm_silu_backward_plan`` for K2,
which the CPU tests hold to its rules.

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
from typing import NamedTuple

import torch
import torch.nn.functional as F

from baddiffusion_tpu_torch.ops import _build

# K1's and K2's launch plans (csrc/groupnorm_silu.cu, csrc/groupnorm_silu_bwd.cu):
# the H100's limits, and the plans' choices
SMEM_PER_BLOCK = 232_448  # dynamic shared memory one block may use (227 KB)
MAX_THREADS = 512  # both kernels' launch bound
SECTOR_BYTES = 32
FULL_GRID = 132  # blocks: one per SM
STAGE_BYTES = 64 * 1024  # a wider slab stages more than this: fewer than three blocks per SM
SLAB_THREADS = 256
PACK_BYTES = 16  # the widest pack: one 16-byte load a thread
BWD_PACK = 4  # K2's pack, in elements, unless a slab needs wider: six f32 registers a channel


class SlabPlan(NamedTuple):
    """How K1 or K2 runs one call: ``slab_groups`` consecutive groups per
    block, packs of ``vec`` elements, ``threads`` per block, ``smem_bytes``
    of dynamic shared memory, and the variant: ``staged`` (the activations
    read once, the slab kept in shared memory) or ``two_walk`` (the slab does
    not fit: read twice). ``blocks`` is the grid."""

    slab_groups: int
    vec: int
    threads: int
    smem_bytes: int
    variant: str
    blocks: int


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


def _partial_rows(cols: int, threads: int) -> int:
    """Rows of per-channel partial sums a block reduces (csrc ``partial_rows``)."""
    return threads // 32 if cols < 32 and 32 % cols == 0 and threads % 32 == 0 else threads // cols


def _smem_bytes(hw: int, slab_c: int, slab_groups: int, staged_bytes: tuple, cols: int, threads: int) -> int:
    """A launch's dynamic shared memory (csrc ``smem_bytes_needed``): each
    staged tensor of the slab (its bytes per element in ``staged_bytes``,
    none for two walks), 16-byte aligned, then the f32 partials and the two
    per-group values."""
    staging = sum(-(-hw * slab_c * eb // 16) * 16 for eb in staged_bytes)
    return staging + 4 * (2 * _partial_rows(cols, threads) * slab_c + 2 * slab_groups)


def _slab_plan(batch, hw, c, groups, elem_bytes, align, slab_groups, staged_bytes, variant, max_vec):
    slab_c = slab_groups * (c // groups)
    packs = [v for v in (1, 2, 4, 8)
             if v * elem_bytes <= PACK_BYTES and slab_c % v == 0 and align % (v * elem_bytes) == 0]
    vec = max(v for v in packs if v <= max_vec)
    if slab_c // vec > MAX_THREADS:  # more columns than a block has threads: the widest pack
        vec = max(packs)
    cols = slab_c // vec
    if cols > MAX_THREADS:
        return None
    threads = cols * max(1, min(hw, SLAB_THREADS // cols))
    smem = _smem_bytes(hw, slab_c, slab_groups, staged_bytes, cols, threads)
    if smem > SMEM_PER_BLOCK:
        return None
    return SlabPlan(slab_groups, vec, threads, smem, variant, batch * (groups // slab_groups))


def _slab_widths(c: int, groups: int, elem_bytes: int) -> list:
    """The slab widths a plan may take, in groups, narrowest first: whole groups
    that make a whole number of 32-byte sectors per pixel, and the whole row."""
    cg = c // groups
    return [k for k in range(1, groups + 1) if groups % k == 0 and (k * cg * elem_bytes % SECTOR_BYTES == 0 or k == groups)]


def _plan(batch, hw, c, groups, elem_bytes, align, staged_bytes: tuple, max_vec: int) -> SlabPlan:
    """The rule both kernels' plans follow. The slab is the widest that still
    gives ``FULL_GRID`` blocks and stages at most ``STAGE_BYTES`` (the sum of
    ``staged_bytes`` per element), else the narrowest (then the wider ones);
    it is staged in shared memory where it fits, else walked twice. Packs
    are the widest that divide the slab and the alignment, up to ``max_vec``
    elements where that leaves at most ``MAX_THREADS`` pack columns."""
    _check_groups(c, groups)
    widths = _slab_widths(c, groups, elem_bytes)
    full = [k for k in widths
            if hw * k * (c // groups) * sum(staged_bytes) <= STAGE_BYTES and batch * (groups // k) >= FULL_GRID]
    order = full[::-1] + [k for k in widths if k not in full]
    for staging, variant in ((staged_bytes, "staged"), ((), "two_walk")):
        for k in order:
            plan = _slab_plan(batch, hw, c, groups, elem_bytes, align, k, staging, variant, max_vec)
            if plan is not None:
                return plan
    raise ValueError(f"groupnorm_silu kernel takes groups of at most {MAX_THREADS} packs; got C/G = {c // groups}")


@functools.lru_cache(maxsize=1024)
def groupnorm_silu_plan(batch: int, hw: int, c: int, groups: int, elem_bytes: int, align: int) -> SlabPlan:
    """K1's launch plan for x ``[batch, hw, c]`` of ``elem_bytes`` elements
    whose data (and the output's) is aligned to ``align`` bytes (a power of
    2, at most 16): ``_plan``, with x staged. Cached: the host pays one
    lookup per call."""
    return _plan(batch, hw, c, groups, elem_bytes, align, (elem_bytes,), max_vec=8)


@functools.lru_cache(maxsize=1024)
def groupnorm_silu_backward_plan(batch: int, hw: int, c: int, groups: int, elem_bytes: int, align: int) -> SlabPlan:
    """K2's launch plan for x and the cotangent ``[batch, hw, c]`` of
    ``elem_bytes`` elements, aligned (with dx) to ``align`` bytes: ``_plan``,
    with x and the cotangent staged and packs of at most ``BWD_PACK``
    elements. Cached, as K1's."""
    return _plan(batch, hw, c, groups, elem_bytes, align, (elem_bytes, elem_bytes), max_vec=BWD_PACK)


@functools.lru_cache(maxsize=None)
def _forward_kernel():
    fn = _build.load("groupnorm_silu").bd_groupnorm_silu_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _backward_kernel():
    fn = _build.load("groupnorm_silu_bwd").bd_groupnorm_silu_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
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
    ptrs = x.data_ptr() | out.data_ptr()
    plan = groupnorm_silu_plan(b, h * w, c, num_groups, x.element_size(), min(16, ptrs & -ptrs))
    dev = x.get_device()
    rc = _forward_kernel()(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        *(s.data_ptr() if s is not None else None for s in stats),
        b, h * w, c, num_groups, plan.slab_groups, plan.vec, plan.threads, plan.smem_bytes,
        int(plan.variant == "staged"), float(eps), _build.DTYPE_CODES[x.dtype], dev, _build.current_stream(dev),
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
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel() == 0:
        return dx, torch.zeros_like(weight), torch.zeros_like(bias)
    ptrs = x.data_ptr() | grad_out.data_ptr() | dx.data_ptr()
    plan = groupnorm_silu_backward_plan(b, h * w, c, num_groups, x.element_size(), min(16, ptrs & -ptrs))
    # the [2c] result (dγ then dβ), then the [b, 2c] per-row workspace
    buf = torch.empty((b + 1) * 2 * c, dtype=torch.float32, device=x.device)
    dev = x.get_device()
    rc = _backward_kernel()(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        grad_out.data_ptr(), dx.data_ptr(), buf.data_ptr() + 2 * c * 4, buf.data_ptr(),
        b, h * w, c, num_groups, plan.slab_groups, plan.vec, plan.threads, plan.smem_bytes,
        int(plan.variant == "staged"), _build.DTYPE_CODES[x.dtype], dev, _build.current_stream(dev),
    )
    if rc != 0:
        raise RuntimeError(
            f"groupnorm_silu backward kernel launch failed: cudaError {rc} at shape {tuple(x.shape)} {x.dtype}"
        )
    groupnorm_silu_backward.launches += 1
    return dx, buf[:c], buf[c:2 * c]


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
