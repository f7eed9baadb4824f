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

Each call runs one of five variants, chosen on the host by
``attention_plan`` (cached) and checked again by the kernel's C entry point:
``packed`` (T ≤ 16, D ≤ 32: one thread a query row, the UNet's 1- and
4-token calls), ``tiled`` (bf16 with D ≤ 256 otherwise: tensor-core tiles,
FlashAttention-2's shape), ``tf32x3_wg`` (f32 with D ≤ 64 and T > 16:
Hopper's warpgroup products fed by TMA, each product as three TF32 products
so that it keeps f32 accuracy), ``tf32x3`` (f32 otherwise: ``tiled``'s shape
on ``mma.sync`` with the same three products) and ``wide`` (bf16 with
D > 256: ``tiled``'s products with O's depth split between warps). In the
last two a group of warps shares 16 query rows, each warp owning a slice of
D; the slices' partial scores are added in shared memory in a fixed order.
The source note says what bounds each and how it answers.

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
VARIANTS = ("packed", "tiled", "tf32x3", "wide", "tf32x3_wg")  # the kernel's variant codes, in order
SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may have
PACKED_MAX_T, PACKED_MAX_D = 16, 32
PACKED_THREADS = (256, 128, 64, 32)  # one query row a thread; widest first
TILED_MAX_D = 256
TILED_DEPTHS = (16, 32, 64, 128, 256)  # the instantiations: D is zero-padded to the next
TILED_ROWS = (16, 32, 64)  # the block heights the kernel takes, in query rows (16 a warp)
# tf32x3 and wide: the depth a warp may own (DW) -> the key tiles instantiated
# with it, preferred first; a block's rows (16 a group of D/DW warps) and its
# widest block
SPLIT_PARTS = {"tf32x3": {64: (32, 16), 128: (32, 16)}, "wide": {128: (32,), 256: (32,)}}
SPLIT_ROWS = (16, 32, 64)
# the widest block: 512 threads, where a lane's accumulators fit 128
# registers (tf32x3 at DW = 64, wide at DW = 128), else 256
SPLIT_MAX_THREADS = 512
# tf32x3_wg (f32, D <= 64, T > 16): persistent blocks of a feeding warpgroup
# and two consumer warpgroups of 64 query rows, 64 keys a staged tile, D
# zero-padded to 32 or 64; the ring's stages at each depth
WG_MAX_D = 64
WG_THREADS, WG_ROWS, WG_KEY_TILE = 384, 64, 64
WG_DEPTHS = (32, 64)
WG_STAGES = {32: 4, 64: 2}
WG_TILE_BYTES = 64 * 128  # a [64][32] f32 tile


class AttentionPlan(NamedTuple):
    """How K3 runs one call: the ``variant``, ``threads`` per block, query
    ``rows`` a block owns, keys staged a step (``key_tile``; 0 for packed),
    the ``depth`` the variant runs D at (tiled: D zero-padded to its
    instantiation; tf32x3 and wide: the warps' slices of D together, a
    warp's ``depth`` / (``threads`` / (2 ``rows``)); packed: D),
    ``smem_bytes`` of dynamic shared memory, ``blocks``, the grid, and
    ``stages``, the K/V ring's stages (tf32x3_wg alone; 0 for the rest)."""

    variant: str
    threads: int
    rows: int
    key_tile: int
    depth: int
    smem_bytes: int
    blocks: int
    stages: int = 0


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
    - ``tf32x3_wg`` for f32 with D ≤ 64 and T > 16 (``_wg_plan``): one
      persistent block an SM, a feeding warpgroup and two consumer
      warpgroups of 64 query rows, 64 keys a staged tile, D zero-padded to
      32 or 64.
    - ``tf32x3`` for the rest of f32 and ``wide`` for bf16 with D > 256: a
      group of ``depth``/DW warps shares 16 query rows, each warp DW columns
      of D. The rule follows ``scripts/time_attention.py --sweep`` on the
      H100: tall blocks share each K and V tile among more rows, which pays
      once the grid fills the card several times; on a short grid shorter
      blocks spread the work over more SMs.

      - ``tf32x3``, D ≤ 64 (T ≤ 16, D > 32): one warp a group (DW = 64), 16
        rows a block.
      - ``tf32x3``, D > 64: where 32-row blocks would fill the card four
        times, 64 rows with DW = 128 where they fit (D ≤ 256), else 32 rows
        with DW = 64; otherwise DW = 64 and 32 rows where that still fills
        half the card, else 16.
      - ``wide``: DW = 256 and 64 rows where that fills the card once, else
        DW = 128 and 16 rows.
      - Keys come in tiles of 32 where they fit the shared memory and T is
        longer than 16, else of 16."""
    _check_envelope(t, d, dtype)
    if t <= PACKED_MAX_T and d <= PACKED_MAX_D:
        threads = next((n for n in PACKED_THREADS if _cdiv(bh * t, n) >= FULL_GRID), PACKED_THREADS[-1])
        return AttentionPlan("packed", threads, threads, 0, d, 0, _cdiv(bh * t, threads))
    if dtype == torch.bfloat16 and d <= TILED_MAX_D:
        return _tiled_plan(bh, t, d, TILED_ROWS[-1])
    if dtype == torch.bfloat16:
        if bh * _cdiv(t, 64) >= FULL_GRID:
            return _fitting_split_plan("wide", bh, t, d, 64, 256)
        return _fitting_split_plan("wide", bh, t, d, 16, 128)
    if d <= WG_MAX_D and t > PACKED_MAX_T:
        return _wg_plan(bh, t, d)
    if d <= 64:
        rows = next(r for r in reversed(SPLIT_ROWS) if r == SPLIT_ROWS[0] or r // 2 < t)  # no taller than T needs
        return _fitting_split_plan("tf32x3", bh, t, d, rows, 64)
    if t > 32 and bh * _cdiv(t, 32) >= 4 * FULL_GRID:
        plan = _fitting_split_plan("tf32x3", bh, t, d, 64, 128)
        return plan if plan is not None else _fitting_split_plan("tf32x3", bh, t, d, 32, 64)
    rows = 32 if t > 16 and 2 * bh * _cdiv(t, 32) >= FULL_GRID else 16
    return _fitting_split_plan("tf32x3", bh, t, d, rows, 64)


def _fitting_split_plan(variant: str, bh: int, t: int, d: int, rows: int, part_depth: int):
    """The plan with the first of ``part_depth``'s key tiles that fits and
    is no longer than T needs, or None."""
    tiles = SPLIT_PARTS[variant][part_depth]
    tiles = [n for n in tiles if n // 2 < t] or [min(tiles)]
    plans = (_split_plan(variant, bh, t, d, rows, part_depth, n) for n in tiles)
    return next((plan for plan in plans if plan is not None), None)


def _split_plan(variant: str, bh: int, t: int, d: int, rows: int, part_depth: int, key_tile: int):
    """The ``tf32x3`` or ``wide`` plan with ``rows`` query rows a block,
    ``part_depth`` columns of D a warp and ``key_tile`` keys a step, or None
    where the block would pass the kernel's limits. Shared memory
    (csrc/attention.cu ``split_smem_bytes``): Q of the block's rows, two
    stages of K and V tiles (f32: Q and K rows padded to 8 mod 32 words, V
    rows to 4 mod 32; bf16: 16 bytes a row), and f32 partial scores, a key
    tile's per row and warp, where a group has more than one warp."""
    parts = _cdiv(d, part_depth)
    depth, threads = parts * part_depth, 2 * rows * parts
    if variant == "tf32x3":
        smem = 4 * ((rows + 2 * key_tile) * _pad_to(depth, 8) + 2 * key_tile * _pad_to(depth, 4))
    else:
        smem = 2 * (rows + 4 * key_tile) * (depth + 8)
    smem += 4 * rows * parts * key_tile if parts > 1 else 0
    small_lanes = part_depth == (64 if variant == "tf32x3" else 128)  # accumulators within 128 registers
    max_threads = SPLIT_MAX_THREADS if small_lanes else 256
    if threads > max_threads or smem > SMEM_LIMIT:
        return None
    return AttentionPlan(variant, threads, rows, key_tile, depth, smem, bh * _cdiv(t, rows))


def split_plans(variant: str, bh: int, t: int, d: int) -> list:
    """Every ``variant`` plan the kernel takes at this shape: each block
    height and depth a warp may own (``scripts/time_attention.py --sweep``)."""
    plans = (_split_plan(variant, bh, t, d, rows, p, n)
             for p, tiles in SPLIT_PARTS[variant].items() for n in tiles for rows in SPLIT_ROWS)
    return [plan for plan in plans if plan is not None]


def _wg_plan(bh: int, t: int, d: int) -> AttentionPlan:
    """The ``tf32x3_wg`` plan (csrc/attention.cu ``wg_smem_bytes``,
    ``wg_items``): shared memory for both consumers' Q and, at depth 64, its
    lo part (at 32 the consumers hold Q in registers), the ring's stages of
    five tiles (K, K lo, V, V^T hi, V^T lo), the barriers, 1024 bytes of
    alignment; the grid one block an SM, or one an item where there are
    fewer. An item is two heads where T <= 64, else 128 query rows."""
    depth = next(p for p in WG_DEPTHS if p >= d)
    stages, halves = WG_STAGES[depth], depth // 32
    q_tiles = 2 * halves * (1 if depth == 32 else 2)
    smem = WG_TILE_BYTES * (q_tiles + 5 * halves * stages) + 8 * (3 * stages + 2) + 1024
    items = _cdiv(bh, 2) if t <= WG_ROWS else bh * _cdiv(t, 2 * WG_ROWS)
    return AttentionPlan("tf32x3_wg", WG_THREADS, WG_ROWS, WG_KEY_TILE, depth, smem, min(items, FULL_GRID), stages)


def _pad_to(n: int, r: int) -> int:
    """``n`` rounded up to ``r`` mod 32."""
    return n + (r - n) % 32


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
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 9 + [ctypes.c_void_p]
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
    plan = attention_plan(b * h, t, d, q.dtype)
    _launch(q, k, v, out, scale, plan)
    attention.launches += 1
    attention.variant_launches[plan.variant] += 1
    return out


def _launch(q, k, v, out, scale: float, plan: AttentionPlan) -> None:
    """One launch of the kernel under ``plan`` on checked inputs; raises if
    the kernel refuses the plan or the launch fails."""
    b, h, t, d = q.shape
    dev = q.get_device()
    rc = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b * h, t, d, float(scale), _build.DTYPE_CODES[q.dtype], VARIANTS.index(plan.variant),
        plan.threads, plan.rows, plan.key_tile, plan.depth, plan.smem_bytes, plan.stages, dev,
        _build.current_stream(dev),
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
attention.variant_launches = dict.fromkeys(VARIANTS, 0)  # the same launches by plan variant


def attention_variant_counts() -> dict:
    """``{variant: launches}`` since the last ``ops.reset_launch_counts()``:
    which of K3's plans the calls took (eager launches; a CUDA graph's
    replays are not counted)."""
    return dict(attention.variant_launches)
