"""The nearest-code kernel's launch plan (``ops.vq_nearest_plan``, computed on
the host) held to its rules over a sweep of shapes, the LDM measure's shape,
the plan's and the wrapper's refusals, and the plain twin on the CPU: the
expanded-L2 argmin the VQ quantizer computed before the kernel, bit for bit
(instant)."""

import itertools

import pytest
import torch

from baddiffusion_tpu_torch import ops
from baddiffusion_tpu_torch.ops import vq

SHAPES = list(itertools.product([1, 255, 256, 2049, 67585, 540673, 1 << 20, 5_000_000],
                                [1, 31, 32, 33, 2048, 2049, 8192, 100_000]))


def test_plan_rules_over_a_sweep():
    for n, k in SHAPES:
        plan = ops.vq_nearest_plan(n, k, vq.DIM)
        per_block = plan.threads * plan.vecs
        assert plan.threads == vq.THREADS and plan.vecs in vq.VECS
        assert plan.blocks * per_block >= n > (plan.blocks - 1) * per_block  # the blocks cover N, the last ragged
        wider = [v for v in vq.VECS if v > plan.vecs]
        assert plan.vecs == 1 or plan.blocks >= vq.FILL_BLOCKS  # as many vectors a thread as still fill the card
        assert all(-(-n // (plan.threads * v)) < vq.FILL_BLOCKS for v in wider)
        assert plan.tile % vq.CHUNK == 0 and plan.smem_bytes == plan.tile * 16 <= vq.SMEM_BYTES  # a float4 a code
        assert plan.tile == min(-(-k // vq.CHUNK) * vq.CHUNK, vq.SMEM_BYTES // 16 // vq.CHUNK * vq.CHUNK)


def test_plan_at_the_ldm_measure_shape():
    """256·64·64 vectors of 3 against 8192 codes: 8 vectors a thread in 512
    blocks, the codebook in 4 tiles of 2048 codes (32 KiB of rows)."""
    assert ops.vq_nearest_plan(256 * 64 * 64, 8192, 3) == vq.VQPlan(8, 256, 512, 2048, 32768)


@pytest.mark.parametrize("n,k,d", [(0, 8, 3), (8, 0, 3), (8, 8, 2), (8, 8, 4), (-1, 8, 3), (8, 1 << 31, 3)])
def test_plan_refuses_what_the_kernel_does_not_take(n, k, d):
    with pytest.raises(ValueError, match="vq_nearest takes"):
        ops.vq_nearest_plan(n, k, d)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    z, codebook = torch.randn(10, 3), torch.randn(8, 3)
    with pytest.raises(ValueError, match="contiguous float32"):
        ops.vq_nearest(z.double(), codebook)
    with pytest.raises(ValueError, match="contiguous float32"):
        ops.vq_nearest(torch.randn(3, 10).t(), codebook)
    with pytest.raises(ValueError, match="codebook must be"):
        ops.vq_nearest(z, codebook[:, :2].contiguous())
    with pytest.raises(ValueError, match="codebook must be"):
        ops.vq_nearest(z, codebook.double())


@pytest.mark.parametrize("n,k,d", [(1, 1, 3), (500, 8, 3), (333, 1000, 4), (64, 7, 1)])
def test_plain_twin_is_the_expanded_l2_argmin(n, k, d):
    """The twin is the quantizer's former code: the argmin of ‖z‖² + ‖e‖² −
    2 z·eᵀ over the whole matrix, and the codebook's rows."""
    g = torch.Generator().manual_seed(n + k + d)
    z, codebook = torch.randn(n, d, generator=g), torch.randn(k, d, generator=g)
    dist = z.square().sum(dim=1, keepdim=True) + codebook.square().sum(dim=1)[None, :] - 2.0 * z @ codebook.T
    idx, rows = ops.vq_nearest_plain(z, codebook)
    assert torch.equal(idx, torch.argmin(dist, dim=1)) and torch.equal(rows, codebook[idx])
    assert torch.equal(ops.vq_nearest(z, codebook)[0], idx)
