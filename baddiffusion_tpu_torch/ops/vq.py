"""Nearest codebook row of each latent vector: the VQ-VAE quantizer's search.
A CUDA kernel for Hopper and its plain twin.

Replaces no Pallas kernel: the JAX package builds the whole ``[N, K]``
distance matrix with XLA. At the LDM measure's batch (N = 1,048,576 vectors,
K = 8192 codes) each ``[N, K]`` f32 temporary of that expression is 32 GiB;
``csrc/vq_nearest.cu`` finds each vector's nearest code without one, and
says what bounds it (operations) and how its design answers that. The launch
plan (vectors a thread, blocks, the codebook's tile) is chosen on the host
from the shape alone, ``vq_nearest_plan``, which the CPU tests hold to its
rules.

``z`` is ``[N, D]`` f32, ``codebook`` ``[K, D]`` f32, both contiguous; the
kernel takes D = 3, the ``vq_embed_dim`` of every VQ-VAE configuration of
the repo (the twin any D). The result is (the int64 ``[N]`` indices, the f32
``[N, D]`` codebook rows). The
kernel takes the least ‖e‖² − 2 z·e in f32 (‖z‖² moves no argmin), the
twin the least ‖z‖² + ‖e‖² − 2 z·e (the expanded L2 the JAX package
computes); both give the lowest index among exact ties, and may part only
where two codes lie within f32 rounding of each other.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor goes to the
kernel, or the wrapper raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from baddiffusion_tpu_torch.ops import _build

THREADS = 256  # a block's threads (csrc ``kThreads``)
CHUNK = 32  # codes a vector takes the least of before it compares with its best (csrc ``kChunk``)
DIM = 3  # the vectors' length (csrc ``kDim``)
SMEM_BYTES = 32 * 1024  # a tile's staged codebook rows (csrc ``kSmemBytes``)
VECS = (8, 4, 2, 1)  # vectors a thread, widest first
FILL_BLOCKS = 2 * 132  # two blocks an SM
ROW_BYTES = 16  # a staged code: its D = 3 floats and its ‖e‖², one float4


class VQPlan(NamedTuple):
    """How the kernel runs one shape: ``vecs`` vectors a thread, ``threads``
    a block, ``blocks`` blocks covering N; the codebook staged ``tile``
    codes at a time in ``smem_bytes`` of shared memory (16 bytes a code:
    the code and its ‖e‖²)."""

    vecs: int
    threads: int
    blocks: int
    tile: int
    smem_bytes: int


@functools.lru_cache(maxsize=256)
def vq_nearest_plan(n: int, k: int, d: int) -> VQPlan:
    """The launch plan for ``n`` vectors of dimension ``d`` against ``k``
    codes. A thread holds the most vectors (8, 4, 2 or 1) that still leave
    ``FILL_BLOCKS`` blocks of ``THREADS``, else one; a tile holds as many
    whole chunks of ``CHUNK`` codes as ``SMEM_BYTES`` allow, or the whole
    codebook rounded up to a chunk where that is fewer. Raises on what
    the kernel does not take. Cached: the host pays one lookup a call."""
    if n <= 0 or k <= 0 or d != DIM:
        raise ValueError(f"vq_nearest takes N > 0 vectors of {DIM} elements against K > 0 codes; "
                         f"got N = {n}, D = {d}, K = {k}")
    if k >= 2 ** 31:
        raise ValueError(f"vq_nearest takes fewer than 2**31 codes; got K = {k}")
    vecs = next((v for v in VECS if -(-n // (THREADS * v)) >= FILL_BLOCKS), 1)
    tile = min(-(-k // CHUNK) * CHUNK, SMEM_BYTES // ROW_BYTES // CHUNK * CHUNK)
    return VQPlan(vecs, THREADS, -(-n // (THREADS * vecs)), tile, tile * ROW_BYTES)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("vq_nearest").bd_vq_nearest
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(z: torch.Tensor, codebook: torch.Tensor) -> None:
    if z.dim() != 2 or z.dtype is not torch.float32 or not z.is_contiguous():
        raise ValueError(f"vq_nearest takes a contiguous float32 [N, D] z, got {tuple(z.shape)} {z.dtype}")
    if (codebook.dim() != 2 or codebook.dtype is not torch.float32 or not codebook.is_contiguous()
            or codebook.shape[1] != z.shape[1] or codebook.device != z.device):
        raise ValueError(f"vq_nearest codebook must be a contiguous float32 [K, {z.shape[1]}] tensor on {z.device}; "
                         f"got {tuple(codebook.shape)} {codebook.dtype} on {codebook.device}")


def vq_nearest_plain(z: torch.Tensor, codebook: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the argmin of the expanded L2 ‖z‖² + ‖e‖² −
    2 z·eᵀ over the whole ``[N, K]`` matrix, in f32; returns (indices, the
    codebook rows)."""
    _check(z, codebook)
    d = z.square().sum(dim=1, keepdim=True) + codebook.square().sum(dim=1)[None, :] - 2.0 * z @ codebook.T
    idx = torch.argmin(d, dim=1)
    return idx, codebook[idx]


def vq_nearest(z: torch.Tensor, codebook: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64 ``[N]`` index of each vector's nearest code, the f32 ``[N, D]``
    codebook rows) for f32 ``z`` ``[N, D]`` and ``codebook`` ``[K, D]``, both
    contiguous. CPU → plain version; CUDA → the kernel (counted in
    ``vq_nearest.launches``), or raise."""
    if not z.is_cuda:
        return vq_nearest_plain(z, codebook)
    _check(z, codebook)
    (n, d), k = z.shape, codebook.shape[0]
    idx = torch.empty(n, dtype=torch.int64, device=z.device)
    zq = torch.empty_like(z)
    if n == 0:
        return idx, zq
    plan = vq_nearest_plan(n, k, d)
    dev = z.get_device()
    rc = _kernel()(z.data_ptr(), codebook.data_ptr(), idx.data_ptr(), zq.data_ptr(), n, k, d, plan.vecs,
                   plan.threads, plan.blocks, plan.tile, dev, _build.current_stream(dev))
    if rc != 0:
        raise RuntimeError(f"vq_nearest kernel launch failed: cudaError {rc} at N = {n}, K = {k}, D = {d}")
    vq_nearest.launches += 1
    return idx, zq


vq_nearest.launches = 0
