"""The JAX package's default PRNG, in numpy: enough of ``jax.random`` to draw
the FID proxy extractor's weights bit for bit without JAX.

``PRNGKey(seed)`` is the raw threefry key ``[seed >> 32, seed & 0xffffffff]``
(0 in the high word for a 32-bit seed). ``split`` and the random bits follow
``jax_threefry_partitionable`` (the default since JAX 0.5): counter ``i`` of
an array is the 64-bit pair ``(i >> 32, i & 0xffffffff)`` pushed through
threefry-2x32 (20 rounds) under the key; ``split`` keeps both output words as
the new key, the random bits are their XOR. ``uniform`` sets the 23 mantissa
bits of a float in [1, 2) from the top of the bits, as ``jax.random.uniform``
does, and ``normal`` is √2·erfinv(u) for u uniform in (−1, 1), with erfinv
evaluated as XLA's CPU backend evaluates it in f32 (Giles' single-precision
polynomial over its Cephes log1p, products fused into the sums that use them).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds of the counters ``(x0, x1)`` under the
    2-word ``key`` (uint32 arithmetic, wrapping)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed that fits 32 bits."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**32:
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def _counters(shape: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    i = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64).reshape(shape)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``[num, 2]`` uint32 keys."""
    b0, b1 = threefry2x32(key, *_counters((num,)))
    return np.stack([b0, b1], axis=1)


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """32-bit random bits of ``shape``, as ``jax.random.bits`` draws them."""
    b0, b1 = threefry2x32(key, *_counters(tuple(shape)))
    return b0 ^ b1


def uniform(key: np.ndarray, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform`` in f32 over [minval, maxval)."""
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.float32(1.0).view(np.uint32)).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def _fma(a, b, c) -> np.ndarray:
    """f32 fused multiply-add, as XLA's CPU backend contracts a product into
    the sum that uses it: the f32 product is exact in f64, so the only
    roundings are the sum's to f64 and to f32 (a double rounding that could
    differ from one rounding only on an exact f64 tie)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


_F = np.float32
# XLA's f32 log1p: x + (−x²/2 + x³·P(x)/Q(x)) for |x| < √2 − 1 (Cephes), else log(1 + x)
_LOG1P_SMALL = 0.41421356237309504880
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
              2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
              3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1)
# XLA CPU's f32 log: Cephes' logf polynomial on the mantissa in [√½, √2), exponent added back
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
          -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def _horner(coeffs, x: np.ndarray) -> np.ndarray:
    p = np.full_like(x, _F(coeffs[0]))
    for c in coeffs[1:]:
        p = _fma(p, x, _F(c))
    return p


def _log_f32(v: np.ndarray) -> np.ndarray:
    """log of positive finite f32 ``v``, operation for operation as XLA's CPU
    backend emits it (products fused into the sums that use them)."""
    bits = np.maximum(v, _F(np.finfo(np.float32).tiny)).view(np.int32)
    e = ((bits >> 23) - 127).astype(np.float32) + _F(1.0)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(np.float32)  # mantissa in [0.5, 1)
    low = m < _F(0.707106781186547524)
    x = (m + _F(-1.0)) + np.where(low, m, _F(0.0))
    e = e - np.where(low, _F(1.0), _F(0.0))
    x2 = x * x
    x3 = x2 * x
    a, b, c = (_fma(_fma(x, _F(_LOG_P[i]), _F(_LOG_P[i + 1])), x, _F(_LOG_P[i + 2])) for i in (0, 3, 6))
    y = _fma(_fma(_fma(a, x3, b), x3, c), x3, e * _F(_LOG_Q1))
    return _fma(e, _F(_LOG_Q2), _fma(-x2, _F(0.5), x) + y)


def _log1p_f32(x: np.ndarray) -> np.ndarray:
    x2 = x * x
    ratio = _horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x)
    small = x + _fma(x2, _F(-0.5), (x * x2) * ratio)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(np.abs(x) < _F(_LOG1P_SMALL), small, _log_f32(x + _F(1.0)))


# XLA's f32 erfinv: M. Giles, "Approximating the erfinv function" (GPU Computing Gems, 2011)
_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                   -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """erfinv in f32 as XLA's CPU backend evaluates it."""
    x = np.asarray(x, np.float32)
    w = -_log1p_f32(x * -x)
    central = w < _F(5.0)
    w = np.where(central, w - _F(2.5), np.sqrt(w) - _F(3.0))
    p = np.where(central, _F(_ERFINV_CENTRAL[0]), _F(_ERFINV_TAIL[0]))
    for c, t in zip(_ERFINV_CENTRAL[1:], _ERFINV_TAIL[1:]):
        p = _fma(p, w, np.where(central, _F(c), _F(t)))
    return np.where(np.abs(x) == _F(1.0), x * np.finfo(np.float32).max, p * x).astype(np.float32)


def normal(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal`` in f32: √2·erfinv(u), u uniform in (−1, 1)."""
    lo = np.nextafter(_F(-1.0), _F(0.0))
    return _F(np.sqrt(2)) * erfinv_f32(uniform(key, shape, lo, 1.0))
