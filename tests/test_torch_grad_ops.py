"""The port's differentiable kernel modules on the CPU: K1's saved statistics
and the plain twin of K2 (the GroupNorm+SiLU backward) against the JAX
package's Pallas kernels in interpret mode, the attention Function's gradient
against ``jax.grad`` of the Pallas attention, and the autograd wiring (the
Functions' gradients equal autograd through the plain forwards)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from baddiffusion_tpu.ops.attention import fused_attention
from baddiffusion_tpu.ops.groupnorm import _backward_pallas, _forward_pallas, fused_groupnorm_silu
from baddiffusion_tpu_torch import ops
from baddiffusion_tpu_torch.ops import (
    attention,
    attention_backward_plain,
    attention_plain,
    groupnorm_silu,
    groupnorm_silu_backward,
    groupnorm_silu_backward_plain,
    groupnorm_silu_forward,
    groupnorm_silu_plain,
    groupnorm_stats_plain,
)

# (B, H, W, C, G): the JAX package's own kernel-test shape, main-path shapes
# of the 32 px scratch UNet (an H = W = 1 and a C/G = 24 one among them), and
# a G = 8 case
GN_CASES = [(4, 16, 16, 128, 32), (2, 8, 8, 256, 32), (2, 1, 1, 512, 32), (1, 2, 2, 768, 32), (2, 4, 4, 64, 8)]


def _gn_inputs(b, h, w, c, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    bias = (rng.randn(c) * 0.1).astype(np.float32)
    ct = rng.randn(b, h, w, c).astype(np.float32)
    if dtype != np.float32:  # round x and the cotangent to bf16 once, for both sides
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        ct = np.asarray(jnp.asarray(ct, jnp.bfloat16).astype(jnp.float32))
    return x, scale, bias, ct


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.mark.parametrize("case", GN_CASES, ids=str)
def test_k1_statistics_match_the_pallas_forward(case):
    """K1's saved [B, G] mean/rstd (its plain version) against
    ``_forward_pallas(save_stats=True)``; f32 sums in another order: mean
    atol 1e-6, rstd rtol 1e-5."""
    b, h, w, c, g = case
    x, scale, bias, _ = _gn_inputs(b, h, w, c, seed=sum(case))
    with pltpu.force_tpu_interpret_mode():
        out_j, mean_j, rstd_j = _forward_pallas(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), g, 1e-5, True)
    out, mean, rstd = groupnorm_silu_forward(_t(x), _t(scale), _t(bias), g, 1e-5)
    assert mean.shape == rstd.shape == (b, g) and mean.dtype == rstd.dtype == torch.float32
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rstd_j), rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=1e-5)
    for a, want in zip(groupnorm_stats_plain(_t(x), g, 1e-5), (mean, rstd)):
        assert torch.equal(a, want)


@pytest.mark.parametrize("case", GN_CASES, ids=str)
def test_k2_plain_matches_the_pallas_backward(case):
    """The plain twin of K2 against ``_backward_pallas`` in interpret mode on
    the same statistics, f32, with the JAX kernel test's tolerances
    (tests/test_ops.py): dx atol 2e-4 rtol 1e-4, dγ/dβ atol 2e-3 rtol 1e-4
    (dγ/dβ are sums over B·H·W elements)."""
    b, h, w, c, g = case
    x, scale, bias, ct = _gn_inputs(b, h, w, c, seed=7 + sum(case))
    with pltpu.force_tpu_interpret_mode():
        _, mean_j, rstd_j = _forward_pallas(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), g, 1e-5, True)
        dx_j, dg_j, db_j = _backward_pallas(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), mean_j, rstd_j,
                                            jnp.asarray(ct), g, 1e-5)
    dx, dg, db = groupnorm_silu_backward_plain(_t(x), _t(scale), _t(bias), _t(mean_j), _t(rstd_j), _t(ct), g)
    assert dx.dtype == torch.float32 and dg.dtype == db.dtype == torch.float32 and dg.shape == (c,)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(dg.numpy(), np.asarray(dg_j), atol=2e-3, rtol=1e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(db_j), atol=2e-3, rtol=1e-4)


def test_groupnorm_silu_gradient_matches_jax_grad_of_the_pallas_kernel():
    """The port's differentiable ``groupnorm_silu`` (forward with saved
    statistics, backward through the K2 twin on a CPU tensor) against
    ``jax.grad`` of ``fused_groupnorm_silu`` (the JAX custom_vjp over both
    Pallas kernels), on the JAX kernel test's inputs and tolerances."""
    x, scale, bias, ct = _gn_inputs(4, 16, 16, 128, seed=3)

    def loss(a, s, bb):
        return jnp.vdot(fused_groupnorm_silu(a, s, bb, 32), jnp.asarray(ct))

    with pltpu.force_tpu_interpret_mode():
        gx_j, gs_j, gb_j = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    xt, st, bt = (_t(a).requires_grad_() for a in (x, scale, bias))
    (groupnorm_silu(xt, st, bt, 32) * _t(ct)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gs_j), atol=2e-3, rtol=1e-4)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb_j), atol=2e-3, rtol=1e-4)


def test_k2_plain_bf16_multiblock_matches_jax_grad():
    """bf16 activations at the JAX test's multi-block shape (B = 16 runs the
    Pallas backward over two sequential batch blocks, so its dγ/dβ are
    carried across the grid). Both sides compute in f32 from the same bf16
    x and cotangent and round dx to bf16: dx atol 1e-2 rtol 1e-2 (one bf16
    ulp is 2⁻⁸ relative), dγ/dβ rtol 1e-3 atol 1e-2 (f32 sums of 16K
    terms in another order)."""
    x, scale, bias, ct = _gn_inputs(16, 32, 32, 128, seed=5, dtype=jnp.bfloat16)
    xb, ctb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(ct, jnp.bfloat16)

    def loss(a, s, bb):
        return jnp.vdot(fused_groupnorm_silu(a, s, bb, 32).astype(jnp.float32), ctb.astype(jnp.float32))

    with pltpu.force_tpu_interpret_mode():
        gx_j, gs_j, gb_j = jax.grad(loss, argnums=(0, 1, 2))(xb, jnp.asarray(scale), jnp.asarray(bias))
    xt = _t(x, torch.bfloat16).requires_grad_()
    st, bt = (_t(a).requires_grad_() for a in (scale, bias))
    out = groupnorm_silu(xt, st, bt, 32)
    assert out.dtype == torch.bfloat16
    out.backward(_t(ct, torch.bfloat16))
    assert xt.grad.dtype == torch.bfloat16 and st.grad.dtype == torch.float32
    np.testing.assert_allclose(xt.grad.float().numpy(), np.asarray(gx_j, np.float32), atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gs_j), rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb_j), rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_groupnorm_silu_function_equals_autograd_through_the_plain_forward(dtype):
    """The hand-derived backward (K2's formulas) against torch autograd
    through ``groupnorm_silu_plain``: f32 atol 1e-5; bf16 dx within one bf16
    ulp of its f32 value (atol 2e-2, rtol 1e-2), dγ/dβ f32 (atol 1e-3)."""
    x, scale, bias, ct = _gn_inputs(2, 4, 4, 64, seed=11)
    xt, st, bt = _t(x, dtype).requires_grad_(), _t(scale).requires_grad_(), _t(bias).requires_grad_()
    groupnorm_silu(xt, st, bt, 8, 1e-6).backward(_t(ct, dtype))
    xr, sr, br = _t(x, dtype).requires_grad_(), _t(scale).requires_grad_(), _t(bias).requires_grad_()
    groupnorm_silu_plain(xr, sr, br, 8, 1e-6).backward(_t(ct, dtype))
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=2e-2, rtol=1e-2)
    torch.testing.assert_close(xt.grad.float(), xr.grad.float(), **tol)
    torch.testing.assert_close(st.grad, sr.grad, atol=1e-3 if dtype != torch.float32 else 1e-5, rtol=1e-4)
    torch.testing.assert_close(bt.grad, br.grad, atol=1e-3 if dtype != torch.float32 else 1e-5, rtol=1e-4)


def test_groupnorm_silu_backward_wrapper_takes_the_plain_path_on_the_cpu():
    ops.reset_launch_counts()
    x, scale, bias, ct = (_t(a) for a in _gn_inputs(2, 2, 2, 64, seed=2))
    mean, rstd = groupnorm_stats_plain(x, 32, 1e-5)
    got = groupnorm_silu_backward(x, scale, bias, mean, rstd, ct, 32)
    want = groupnorm_silu_backward_plain(x, scale, bias, mean, rstd, ct, 32)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.launch_counts() == {"groupnorm_silu": 0, "groupnorm_silu_backward": 0, "attention": 0,
                                   "bias_shift": 0, "bias_shift_backward": 0, "vq_nearest": 0}
    with pytest.raises(ValueError, match=r"mean/rstd must be \[2, 32\]"):
        groupnorm_silu_backward_plain(x, scale, bias, mean[:, :8], rstd[:, :8], ct, 32)


# [B, H, T, D]: the UNet's attention shapes at batch 2, and a longer one
ATTN_SHAPES = [(2, 64, 4, 8), (2, 64, 1, 8), (1, 2, 64, 32)]


@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=str)
def test_attention_gradient_matches_jax_grad_of_the_pallas_kernel(shape):
    """The attention Function (kernel forward, plain f32 backward) against
    ``jax.grad`` of ``fused_attention`` in interpret mode, whose backward is
    XLA autodiff through the jnp reference: f32, atol 1e-5 rtol 1e-5."""
    rng = np.random.RandomState(shape[2] + shape[3])
    q, k, v, ct = (rng.randn(*shape).astype(np.float32) for _ in range(4))
    scale = 1.0 / np.sqrt(shape[-1])

    def loss(a, b, c):
        return jnp.vdot(fused_attention(a, b, c, scale), jnp.asarray(ct))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    (attention(qt, kt, vt, scale) * _t(ct)).sum().backward()
    for got, w in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_attention_backward_plain_equals_autograd_and_keeps_dtypes(dtype):
    """``attention_backward_plain`` against torch autograd through
    ``attention_plain`` (f32 atol 1e-5; bf16: both round the f32 result to
    bf16 once, atol 1e-2 rtol 1e-2)."""
    g = torch.Generator().manual_seed(4)
    q, k, v, ct = (torch.randn(2, 3, 9, 16, generator=g).to(dtype) for _ in range(4))
    got = attention_backward_plain(q, k, v, 0.25, ct)
    qr, kr, vr = (a.clone().requires_grad_() for a in (q, k, v))
    attention_plain(qr, kr, vr, 0.25).backward(ct)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=1e-2, rtol=1e-2)
    for a, b in zip(got, (qr.grad, kr.grad, vr.grad)):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), **tol)
