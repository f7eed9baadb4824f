"""The port's CUDA kernels on the card, beyond the main path's shapes: every
pack width and lane layout, misaligned and partial-tile inputs, the wrappers'
refusals, and a small UNet on the card against the CPU's plain path.

These tests need an NVIDIA GPU and skip without one. Run them on the card
without the JAX-side conftest (this file imports no JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from baddiffusion_tpu_torch import ops
from baddiffusion_tpu_torch.models import UNet2DConfig, UNet2DModel

pytestmark = pytest.mark.cuda
TOL = {torch.float32: dict(atol=1e-5, rtol=0.0), torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gn_args(shape, dtype, dev, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    c = shape[-1]
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    w = (torch.rand(c, generator=g, device=dev) + 0.5).to(dtype)
    b = (0.1 * torch.randn(c, generator=g, device=dev)).to(dtype)
    return x, w, b


# (shape, groups): group widths 1, 2, 3, 8, 32 (every pack width), G = 1
GN_CASES = [((2, 5, 7, 32), 32), ((3, 5, 7, 64), 32), ((2, 3, 3, 96), 32), ((2, 4, 4, 64), 8), ((2, 8, 8, 32), 1)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,groups", GN_CASES)
def test_groupnorm_silu_kernel_matches_plain(dev, shape, groups, dtype):
    x, w, b = _gn_args(shape, dtype, dev)
    got = ops.groupnorm_silu(x, w, b, groups, 1e-6)
    torch.testing.assert_close(got.float(), ops.groupnorm_silu_plain(x, w, b, groups, 1e-6).float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_groupnorm_silu_kernel_takes_misaligned_storage(dev, dtype):
    """A contiguous view one element into its storage: the kernel narrows
    its pack width to the pointers' alignment."""
    x, w, b = _gn_args((2, 4, 4, 256), dtype, dev)
    shifted = torch.empty(x.numel() + 1, dtype=dtype, device=dev)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    torch.testing.assert_close(ops.groupnorm_silu(shifted, w, b, 32).float(),
                               ops.groupnorm_silu_plain(x, w, b, 32).float(), **TOL[dtype])


def test_groupnorm_silu_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x, w, b = _gn_args((2, 4, 4, 64), torch.float32, dev)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        ops.groupnorm_silu(x.permute(0, 2, 1, 3), w, b, 32)  # strided, not NHWC-contiguous
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.groupnorm_silu(x.half(), w.half(), b.half(), 32)
    with pytest.raises(ValueError, match="weight"):
        ops.groupnorm_silu(x, w.to(torch.bfloat16), b, 32)
    with pytest.raises(ValueError, match="not divisible"):
        ops.groupnorm_silu(x, w, b, 24)
    with pytest.raises(NotImplementedError, match="forward-only"):
        ops.groupnorm_silu(x.requires_grad_(), w, b, 32)


def test_launch_counters_count_kernel_launches_only(dev):
    ops.reset_launch_counts()
    x, w, b = _gn_args((1, 2, 2, 64), torch.float32, dev)
    ops.groupnorm_silu(x, w, b, 32)
    ops.groupnorm_silu_plain(x, w, b, 32)
    q = torch.randn(1, 2, 3, 8, device=dev)
    ops.attention(q, q, q, 0.5)
    ops.attention_plain(q, q, q, 0.5)
    ops.groupnorm_silu(x.cpu(), w.cpu(), b.cpu(), 32)
    assert ops.launch_counts() == {"groupnorm_silu": 1, "attention": 1}


# [B, H, T, D]: 8- and 16-lane rows, masked lanes (D 24, 40), the largest D
# with a partial last K/V tile, the longest T
ATTN_CASES = [(2, 3, 17, 8), (1, 2, 33, 16), (2, 3, 17, 24), (2, 2, 7, 40), (1, 1, 1000, 512), (1, 2, 1024, 8)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", ATTN_CASES)
def test_attention_kernel_matches_plain(dev, shape, dtype):
    g = torch.Generator(dev).manual_seed(sum(shape))
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(3))
    scale = shape[-1] ** -0.5
    got = ops.attention(q, k, v, scale)
    torch.testing.assert_close(got.float(), ops.attention_plain(q, k, v, scale).float(), **TOL[dtype])


def test_attention_wrapper_refuses_outside_the_envelope(dev):
    for shape in [(1, 1, 1025, 8), (1, 1, 4, 4), (1, 1, 4, 12), (1, 1, 4, 520)]:
        q = torch.zeros(shape, device=dev)
        with pytest.raises(ValueError, match="envelope"):
            ops.attention(q, q, q, 1.0)
    q = torch.zeros(1, 2, 4, 8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        ops.attention(q, q.transpose(1, 2).contiguous().transpose(1, 2), q, 1.0)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_small_unet_on_the_card_matches_the_cpu(dev, dtype):
    cfg = UNet2DConfig(
        sample_size=16, layers_per_block=1, block_out_channels=(32, 64), norm_num_groups=8, attention_head_dim=8,
        down_block_types=("DownBlock2D", "AttnDownBlock2D"), up_block_types=("AttnUpBlock2D", "UpBlock2D"),
    )
    cpu = UNet2DModel(cfg, device="cpu")
    card = UNet2DModel(cfg).to(dtype)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([5, 600])
    ops.reset_launch_counts()
    with torch.no_grad():
        got = card(x.to(dev), t.to(dev)).cpu()
        want = cpu.to(dtype)(x, t)
    # 2 fused norms per resnet: 2 down, 2 mid, 4 up; plus conv_norm_out
    assert ops.launch_counts() == {"groupnorm_silu": 2 * (2 + 2 + 4) + 1, "attention": 4}
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 else dict(atol=0.1, rtol=0.05)
    torch.testing.assert_close(got, want, **tol)
