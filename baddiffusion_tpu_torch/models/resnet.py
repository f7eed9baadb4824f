"""ResNet block and resampling layers, FIR resampling included (port of
``baddiffusion_tpu/models/resnet.py``).

Layout: every module takes and returns NHWC tensors, as the JAX package does.
An NHWC tensor that is contiguous is an NCHW tensor in ``torch.channels_last``
memory, so ``Conv2d`` hands cuDNN a channels_last NCHW view and views its
channels_last result back as NHWC, without a copy. Concatenation, nearest
upsampling and padding therefore all work on the channel-last axis and can
never hand the GroupNorm kernel a tensor in NCHW-contiguous memory.

Compute dtype as flax does it: parameters keep their own dtype (f32), and
``Conv2d``/``Linear`` cast their weight (``Linear`` its bias too) to the
dtype of the activation they are given, so a bf16 activation makes a bf16
product and autograd hands back f32 gradients through the cast. A weight
already in that dtype is not copied. A conv's bias is added in f32 to the
product and rounded once (``ops.conv2d_bias_shift``, a kernel pair on the card).
GroupNorm statistics are single-pass f32, clamped, with the affine applied in
f32 from f32 γ/β (ops/groupnorm.py). Every GroupNorm that a SiLU follows goes
through the fused kernels on the card (K1 forward, K2 backward).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from baddiffusion_tpu_torch.ops import conv2d_bias_shift, groupnorm_plain, groupnorm_silu


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` on NHWC activations (weights stay OIHW), computed in the
    activation's dtype, with zero padding. cuDNN runs the conv without its
    bias; the f32 bias, and ``row`` (a ``[B, C_out]`` shift in x's dtype: a
    resnet's time embedding) where given, are then added in one pass in
    place, summed in f32 and rounded once (``ops.conv2d_bias_shift``)."""

    def forward(self, x: torch.Tensor, row: Optional[torch.Tensor] = None) -> torch.Tensor:
        bias = self.bias if self.bias.dtype is torch.float32 else self.bias.float()
        return conv2d_bias_shift(x, self.weight, bias, row, self.stride, self.padding, self.dilation, self.groups)


class Linear(nn.Linear):
    """``nn.Linear`` computed in the activation's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class GroupNorm(nn.Module):
    """GroupNorm over the channel (last) axis with f32 single-pass statistics
    and an f32 affine, output in x's dtype; ``silu=True`` fuses the SiLU that
    follows (the GroupNorm+SiLU kernels). γ/β reach the kernels in f32: a
    module cast to another dtype pays one cast of each per call."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5, silu: bool = False):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"channels {num_channels} not divisible by num_groups {num_groups}")
        self.num_groups = num_groups
        self.eps = eps
        self.silu = silu
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.weight.float(), self.bias.float()
        if self.silu:
            return groupnorm_silu(x, weight, bias, self.num_groups, self.eps)
        return groupnorm_plain(x, weight, bias, self.num_groups, self.eps)


class Upsample2D(nn.Module):
    """Nearest 2x upsample, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample_nearest(x))


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv downsample.

    ``padding=0`` reproduces the google/ddpm checkpoints' asymmetric pad (one
    row at the bottom, one column at the right) before an unpadded conv.
    """

    def __init__(self, channels: int, padding: int = 1):
        super().__init__()
        self.padding = padding
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == 0:
            x = F.pad(x, (0, 0, 0, 1, 0, 1))  # NHWC: C untouched, W and H +1 at the end
        return self.conv(x)


def upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of NHWC ``x``."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, of NHWC ``x``."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


# --------------------------------------------------------------------------
# FIR resampling (the NCSN++ skip blocks). The JAX package has no Pallas
# kernel here: upfirdn is a depthwise convolution, left to cuDNN.
# --------------------------------------------------------------------------

FIR_KERNEL = (1, 3, 3, 1)


def _fir_kernel_2d(kernel=FIR_KERNEL, gain: float = 1.0) -> np.ndarray:
    k = np.asarray(kernel, dtype=np.float32)
    k = np.outer(k, k)
    return k / k.sum() * gain


@functools.lru_cache(maxsize=256)
def _depthwise_weight(taps: bytes, shape: tuple, channels: int, device: torch.device,
                      dtype: torch.dtype) -> torch.Tensor:
    """A FIR kernel, flipped, as a ``[C, 1, kh, kw]`` depthwise weight on ``device``,
    made once: a copy from pageable host memory would wait for the stream
    at every call. Made outside inference mode, so that a weight first made
    while sampling can serve a training step's autograd later."""
    k = np.frombuffer(taps, np.float32).reshape(shape)
    with torch.inference_mode(False):
        k = torch.tensor(k[::-1, ::-1].copy())
        return k[None, None].expand(channels, 1, *shape).contiguous().to(device, dtype)


def upfirdn2d(x: torch.Tensor, kernel: np.ndarray, up: int = 1, down: int = 1, pad=(0, 0)) -> torch.Tensor:
    """NHWC upfirdn: zero-insertion upsample by ``up``, pad (``pad[0]`` before,
    ``pad[1]`` after; negative crops), convolve with ``kernel`` (flipped, a
    true convolution) in x's dtype, keep every ``down``-th pixel."""
    b, h, w, c = x.shape
    lo, hi = pad
    kernel = np.asarray(kernel, np.float32)
    if up > 1:
        x = F.pad(x.reshape(b, h, 1, w, 1, c), (0, 0, 0, up - 1, 0, 0, 0, up - 1)).reshape(b, h * up, w * up, c)
    x = F.pad(x, (0, 0, max(lo, 0), max(hi, 0), max(lo, 0), max(hi, 0)))
    if lo < 0 or hi < 0:
        x = x[:, max(-lo, 0): x.shape[1] - max(-hi, 0), max(-lo, 0): x.shape[2] - max(-hi, 0), :]
    weight = _depthwise_weight(kernel.tobytes(), kernel.shape, c, x.device, x.dtype)
    return F.conv2d(x.permute(0, 3, 1, 2), weight, stride=down, groups=c).permute(0, 2, 3, 1)


def upsample_2d_fir(x: torch.Tensor, kernel=FIR_KERNEL, factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    k = _fir_kernel_2d(kernel, gain * factor**2)
    p = k.shape[0] - factor
    return upfirdn2d(x, k, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d_fir(x: torch.Tensor, kernel=FIR_KERNEL, factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    k = _fir_kernel_2d(kernel, gain)
    p = k.shape[0] - factor
    return upfirdn2d(x, k, down=factor, pad=((p + 1) // 2, p // 2))


class FirUpsample2D(nn.Module):
    """FIR 2x upsample, then (``use_conv``) a 3x3 conv."""

    def __init__(self, channels: int, use_conv: bool = False, fir_kernel=FIR_KERNEL):
        super().__init__()
        self.fir_kernel = tuple(fir_kernel)
        self.Conv2d_0 = Conv2d(channels, channels, 3, padding=1) if use_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = upsample_2d_fir(x, self.fir_kernel)
        return x if self.Conv2d_0 is None else self.Conv2d_0(x)


class FirDownsample2D(nn.Module):
    """FIR 2x downsample, then (``use_conv``) a 3x3 conv."""

    def __init__(self, channels: int, use_conv: bool = False, fir_kernel=FIR_KERNEL):
        super().__init__()
        self.fir_kernel = tuple(fir_kernel)
        self.Conv2d_0 = Conv2d(channels, channels, 3, padding=1) if use_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = downsample_2d_fir(x, self.fir_kernel)
        return x if self.Conv2d_0 is None else self.Conv2d_0(x)


def _resampler(up: bool, down: bool, kernel: Optional[str]):
    """The function a ResnetBlock2D applies to x and to its hidden state
    when it resamples: FIR with ``kernel="fir"``; else nearest up, or a 2x2
    average pool down (``"sde_vp"`` and None alike); None when it does not."""
    if up:
        return upsample_2d_fir if kernel == "fir" else upsample_nearest
    if down:
        return downsample_2d_fir if kernel == "fir" else avg_pool_2x2
    return None


class ResnetBlock2D(nn.Module):
    """norm1 → SiLU → [resample x and hidden] → conv1 → (+ time proj) →
    norm2 → [scale_shift] → SiLU → dropout → conv2 → (+ shortcut) /
    output_scale_factor.

    ``temb_channels=None`` makes a block without a time projection (the
    VAE's); its norm2 then fuses the SiLU whatever ``time_embedding_norm``
    says, as the JAX block routes it. ``groups_out`` is norm2's group count
    (default ``groups``); ``use_in_shortcut`` forces the 1x1 shortcut conv
    (default: when the channels change); ``up``/``down`` resample with
    ``kernel`` None, ``"fir"`` or ``"sde_vp"``."""

    def __init__(
        self,
        in_channels: int,
        out_channels: Optional[int],
        temb_channels: Optional[int],
        groups: int = 32,
        eps: float = 1e-6,
        time_embedding_norm: str = "default",
        output_scale_factor: float = 1.0,
        dropout: float = 0.0,
        groups_out: Optional[int] = None,
        kernel: Optional[str] = None,
        use_in_shortcut: Optional[bool] = None,
        up: bool = False,
        down: bool = False,
    ):
        super().__init__()
        if time_embedding_norm not in ("default", "scale_shift"):
            raise ValueError(f"time_embedding_norm {time_embedding_norm!r}")
        if kernel not in (None, "fir", "sde_vp"):
            raise ValueError(f"kernel {kernel!r}")
        out_channels = out_channels or in_channels
        self.scale_shift = time_embedding_norm == "scale_shift" and temb_channels is not None
        self.output_scale_factor = output_scale_factor
        self.resample = _resampler(up, down, kernel)
        self.norm1 = GroupNorm(groups, in_channels, eps, silu=True)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (
            None if temb_channels is None
            else Linear(temb_channels, 2 * out_channels if self.scale_shift else out_channels)
        )
        # scale_shift modulates between the norm and the SiLU, so norm2 is
        # plain there; the default form fuses the SiLU into the kernel
        self.norm2 = GroupNorm(groups_out or groups, out_channels, eps, silu=not self.scale_shift)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        if use_in_shortcut is None:
            use_in_shortcut = in_channels != out_channels
        self.conv_shortcut = Conv2d(in_channels, out_channels, 1) if use_in_shortcut else None

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        hidden = self.norm1(x)
        if self.resample is not None:
            x, hidden = self.resample(x), self.resample(hidden)
        proj = None if self.time_emb_proj is None or temb is None else self.time_emb_proj(F.silu(temb))
        # the default form's time projection rides on conv1's bias pass; rebinding ``hidden`` frees norm1's
        # output before norm2 allocates its own
        hidden = self.conv1(hidden, row=None if self.scale_shift else proj)
        if not self.scale_shift:
            hidden = self.norm2(hidden)
        elif proj is None:
            hidden = F.silu(self.norm2(hidden))
        else:
            scale, shift = proj[:, None, None, :].chunk(2, dim=-1)
            hidden = F.silu(self.norm2(hidden) * (1 + scale) + shift)
        hidden = self.conv2(self.dropout(hidden))

        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        out = x + hidden
        # x / 1.0 is x: skip the launch
        return out if self.output_scale_factor == 1.0 else out / self.output_scale_factor
