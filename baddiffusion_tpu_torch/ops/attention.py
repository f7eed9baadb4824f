"""Self-attention forward (K3): a CUDA kernel for Hopper and its plain twin,
with a backward in plain PyTorch.

Port of ``baddiffusion_tpu/ops/attention.py``. The kernel,
``csrc/attention.cu``, replaces the Pallas TPU kernel
``_forward_pallas``/``_kernel``: softmax(q·kᵀ·scale)·v per (batch, head) over
``[B, H, T, D]``, with the softmax and every sum in f32 and no ``[T, T]``
tensor in memory. Envelope: T ≤ 4096 (the VQ-VAE's mid block at a 64×64
latent, the longest sequence of any model of the repo), D a multiple of 8 in
[8, 512]; f32 or bf16, contiguous, 16-byte aligned. The JAX ``attention``
has no bound on T (outside its Pallas envelope it runs its reference); here
a call outside the envelope raises.

Each call runs one of three variants, chosen on the host by
``attention_plan`` (cached) and checked again by the kernel's C entry point:
``packed`` (T ≤ 16, D ≤ 32: one thread a query row, the UNet's 1- and
4-token calls), ``tiled`` (bf16 with D ≤ 256 otherwise: tensor-core tiles,
FlashAttention-2's shape) and ``rowwise`` (the rest: f32 at longer T or wider
D, and D > 256). The source note says what bounds each and how it answers.

``attention`` is differentiable (``_Attention``): the kernel runs the
forward, and the backward recomputes the f32 softmax and applies the
attention VJP in plain PyTorch, as the JAX ``custom_vjp`` leaves its backward
to XLA; the TPU package has no backward kernel to port.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor goes to the
kernel under its plan, or the wrapper raises. There is no fallback between
variants or to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from baddiffusion_tpu_torch.ops import _build

MAX_T = 4096
MIN_D, MAX_D = 8, 512
# K3's launch plan (csrc/attention.cu): the H100's SMs, and the plan's choices
FULL_GRID = 132  # blocks: one per SM
VARIANTS = ("packed", "tiled", "rowwise")  # the kernel's variant codes, in order
PACKED_MAX_T, PACKED_MAX_D = 16, 32
PACKED_THREADS = (256, 128, 64, 32)  # one query row a thread; widest first
TILED_MAX_D = 256
TILED_DEPTHS = (16, 32, 64, 128, 256)  # the instantiations: D is zero-padded to the next
TILED_ROWS = (16, 32, 64)  # the block heights the kernel takes, in query rows (16 a warp)
ROWWISE_MAX_WARPS = 4
ROWWISE_SMEM_FLOATS = 8192  # the K and V tiles together, in f32


class AttentionPlan(NamedTuple):
    """How K3 runs one call: the ``variant``, ``threads`` per block, query
    ``rows`` a block owns, keys staged a step (``key_tile``; 0 for packed),
    the ``depth`` the variant runs D at (tiled: D zero-padded to its
    instantiation; else D), ``smem_bytes`` of dynamic shared memory, and
    ``blocks``, the grid."""

    variant: str
    threads: int
    rows: int
    key_tile: int
    depth: int
    smem_bytes: int
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check_envelope(t: int, d: int, dtype) -> None:
    if not (1 <= t <= MAX_T and MIN_D <= d <= MAX_D and d % 8 == 0):
        raise ValueError(f"attention kernel envelope is T <= {MAX_T}, D in [{MIN_D}, {MAX_D}] with D % 8 == 0; got T={t}, D={d}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attention kernel takes float32 or bfloat16, got {dtype}")


@functools.lru_cache(maxsize=1024)
def attention_plan(bh: int, t: int, d: int, dtype) -> AttentionPlan:
    """K3's launch plan for ``bh`` heads of ``[t, d]`` in ``dtype``. Cached:
    the host pays one lookup per call.

    - ``packed`` where T ≤ 16 and D ≤ 32: one thread a query row; the block is
      the widest that still gives ``FULL_GRID`` blocks, else 32 threads.
    - ``tiled`` for bf16 with D ≤ 256 otherwise: 16 query rows a warp and 64
      rows a block, whatever T and the grid. Each block stages its head's
      whole K and V, so shorter blocks multiply that work: on the H100, 64
      rows were the fastest of the heights the kernel takes (16, 32, 64) at
      every shape timed with ``scripts/time_attention.py``, at 64 blocks and
      at T = 16 too. Keys come
      in tiles of 64 (32 at depth 256); shared memory holds Q and two stages
      of K and V, each row padded by 16 bytes.
    - ``rowwise`` for the rest (f32 at T > 16 or D > 32, and D > 256): a warp
      serves 32/L rows (L = 8, 16 or 32 lanes a row), a block 4 warps (fewer
      only where T is shorter), for the same reason; K and V tiles of 8,192
      f32 together."""
    _check_envelope(t, d, dtype)
    if t <= PACKED_MAX_T and d <= PACKED_MAX_D:
        threads = next((n for n in PACKED_THREADS if _cdiv(bh * t, n) >= FULL_GRID), PACKED_THREADS[-1])
        return AttentionPlan("packed", threads, threads, 0, d, 0, _cdiv(bh * t, threads))
    if dtype == torch.bfloat16 and d <= TILED_MAX_D:
        return _tiled_plan(bh, t, d, TILED_ROWS[-1])
    rows_per_warp = 32 // (8 if d == 8 else 16 if d == 16 else 32)
    warps = min(ROWWISE_MAX_WARPS, _cdiv(t, rows_per_warp))
    key_tile = min(t, ROWWISE_SMEM_FLOATS // (2 * d))
    rows = warps * rows_per_warp
    return AttentionPlan("rowwise", 32 * warps, rows, key_tile, d, 8 * key_tile * d, bh * _cdiv(t, rows))


def _tiled_plan(bh: int, t: int, d: int, rows: int) -> AttentionPlan:
    """The tiled plan with ``rows`` query rows a block (16, 32 or 64)."""
    depth = next(p for p in TILED_DEPTHS if p >= d)
    key_tile = 32 if depth > 128 else 64
    smem = (rows + 4 * key_tile) * (depth + 8) * 2
    return AttentionPlan("tiled", 2 * rows, rows, key_tile, depth, smem, bh * _cdiv(t, rows))


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
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_inputs(q, k, v) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"attention takes CPU or CUDA tensors, got {q.device}")
    if q.dim() != 4:
        raise ValueError(f"attention expects [B, H, T, D], got shape {tuple(q.shape)}")
    _, _, t, d = q.shape
    _check_envelope(t, d, q.dtype)
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.shape != q.shape or a.dtype != q.dtype or a.device != q.device:
            raise ValueError(f"attention {name} must match q: {tuple(q.shape)} {q.dtype} on {q.device}")
        if not a.is_contiguous():
            raise ValueError(f"attention kernel needs contiguous [B, H, T, D] inputs; {name} has strides {a.stride()}")
        if a.data_ptr() % 16:
            raise ValueError(f"attention kernel needs 16-byte aligned inputs; {name} starts at {a.data_ptr():#x}")


def _forward(q, k, v, scale: float) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    _check_cuda_inputs(q, k, v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if q.numel() == 0:
        return out
    b, h, t, d = q.shape
    _launch(q, k, v, out, scale, attention_plan(b * h, t, d, q.dtype))
    attention.launches += 1
    return out


def _launch(q, k, v, out, scale: float, plan: AttentionPlan) -> None:
    """One launch of the kernel under ``plan`` on checked inputs; raises if
    the kernel refuses the plan or the launch fails."""
    b, h, t, d = q.shape
    with torch.cuda.device(q.device):
        rc = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, t, d, float(scale), _build.DTYPE_CODES[q.dtype], VARIANTS.index(plan.variant),
            plan.threads, plan.rows, plan.key_tile, plan.depth, plan.smem_bytes,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"attention kernel launch failed: cudaError {rc} at shape {tuple(q.shape)} {q.dtype}, plan {plan}"
        )


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
