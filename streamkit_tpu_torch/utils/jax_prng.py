# SPDX-License-Identifier: Apache-2.0
"""``jax.random``'s threefry draws, reproduced in numpy.

The JAX package draws Kokoro's random weights (``models/kokoro.py``
``kokoro_init_params``) and Matcha's ODE noise (``models/matcha.py``
``matcha_synthesize_mel``) with ``jax.random``. The port draws the same
numbers here, on the host, and hands them to torch, so a model without a
checkpoint is the reference's model and its noise the reference's noise.

The rule followed is JAX's default, ``jax_threefry_partitionable = True``:

* a key is two ``uint32`` words; ``PRNGKey(seed)`` is ``[seed >> 32, seed]``;
* ``split(key, n)`` and ``random_bits(key, shape)`` run Threefry-2x32 (20
  rounds, Salmon et al., "Parallel random numbers: as easy as 1, 2, 3",
  SC 2011) over the row-major flat index of the output, split into its high
  and low 32 bits; ``split`` keeps both output words as the new key, 32-bit
  ``random_bits`` is their exclusive or;
* ``uniform`` puts the top 23 bits in the mantissa of a float in [1, 2),
  subtracts 1, scales to ``[minval, maxval)`` and clamps at ``minval``;
* ``normal`` is ``√2 · erfinv(uniform(nextafter(−1, 0), 1))``, with the
  single-precision erfinv polynomial of M. Giles ("Approximating the erfinv
  function", GPU Computing Gems, 2011), the one XLA evaluates;
* XLA's CPU code fuses each ``a · b + c`` into one rounding and computes
  ``log1p`` with Cephes' rational and polynomial: the port does the same,
  so its floats are JAX's bit for bit.

Every array is numpy; nothing here touches a device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = ["PRNGKey", "split", "random_bits", "uniform", "normal", "erf_inv", "threefry2x32"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = np.uint32


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds: ``key`` ``[2]`` uint32, counters
    ``x0``, ``x1`` uint32 arrays of one shape → the two output words."""
    k0, k1 = (np.asarray(key, _U32).reshape(2)[i] for i in range(2))
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    x0 = np.asarray(x0, _U32) + ks[0]
    x1 = np.asarray(x1, _U32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    """The key of ``jax.random.PRNGKey(seed)`` for ``0 <= seed < 2**32``."""
    seed = int(seed)
    if not 0 <= seed < 1 << 32:
        raise ValueError(f"seed {seed} is outside [0, 2**32)")
    return np.asarray([seed >> 32, seed & 0xFFFFFFFF], _U32)


def _counters(shape: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """The row-major flat index of ``shape`` as (high, low) 32-bit words."""
    idx = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64).reshape(tuple(shape))
    return (idx >> np.uint64(32)).astype(_U32), (idx & np.uint64(0xFFFFFFFF)).astype(_U32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``[num, 2]`` uint32 keys."""
    hi, lo = _counters((num,))
    b0, b1 = threefry2x32(key, hi, lo)
    return np.stack([b0, b1], axis=-1)


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)``."""
    hi, lo = _counters(shape)
    b0, b1 = threefry2x32(key, hi, lo)
    return b0 ^ b1


def _fma(a, b, c) -> np.ndarray:
    """``a * b + c`` rounded once to float32, as XLA's CPU code contracts
    it (the float64 product of two float32 values is exact)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def uniform(key: np.ndarray, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(key, shape)
    floats = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


def _polynomial(x: np.ndarray, coeffs) -> np.ndarray:
    """Horner's rule with one rounding per step, highest power first."""
    p = np.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, np.float32(c))
    return p


# Cephes' log1p rational on |t| < √2 − 1 (numerator, denominator), and its
# log on [√½, √2) (Pommier's split of the degree-8 polynomial), as XLA's CPU
# code evaluates them
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
              2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
              3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG_P = [np.float32(c) for c in (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
                                  1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
                                  3.3333331174e-1)]


def _log(v: np.ndarray) -> np.ndarray:
    """float32 log of positive normal ``v``, XLA's CPU evaluation."""
    f = np.float32
    m, e = np.frexp(v)
    m, e = m.astype(f), e.astype(f)
    low = m < f(0.707106781186547524)
    x = (m - f(1)) + np.where(low, m, f(0))
    e = e - np.where(low, f(1), f(0))
    x2 = x * x
    x3 = x2 * x
    y, y1, y2 = _fma(_LOG_P[0], x, _LOG_P[1]), _fma(_LOG_P[3], x, _LOG_P[4]), _fma(_LOG_P[6], x, _LOG_P[7])
    y, y1, y2 = _fma(y, x, _LOG_P[2]), _fma(y1, x, _LOG_P[5]), _fma(y2, x, _LOG_P[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * f(-2.12194440e-4))
    x = (x - x2 * f(0.5)) + y
    return _fma(e, f(0.693359375), x)


def _log1p(t: np.ndarray) -> np.ndarray:
    """float32 log1p of ``t`` in (−1, 0], XLA's CPU evaluation."""
    f = np.float32
    t2 = t * t
    small = _polynomial(t, _LOG1P_NUM) / _polynomial(t, _LOG1P_DEN)
    small = t + _fma(f(-0.5), t2, (t * t2) * small)
    return np.where(np.abs(t) < f(0.41421356237309504880), small, _log(np.maximum(t + f(1), f(1e-30))))


# Giles' single-precision coefficients, highest power first: w < 5 and w >= 5
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                 -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                 -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """The inverse error function on (−1, 1) in float32, evaluated as XLA's
    ``ErfInv`` is on the CPU: ``w = −log1p(−x²)``, then one degree-8
    polynomial in ``w − 2.5`` below 5 and another in ``√w − 3`` above, each
    step a fused multiply-add."""
    x = np.asarray(x, np.float32)
    if np.any(np.abs(x) >= 1):
        raise ValueError("erf_inv takes values in (-1, 1)")
    w = -_log1p(x * -x)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.zeros_like(x)
    for cs, cl in zip(_ERFINV_SMALL, _ERFINV_LARGE):
        p = _fma(p, w, np.where(small, np.float32(cs), np.float32(cl)))
    return p * x


def normal(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(key, shape, lo, 1.0)
    return np.float32(np.sqrt(2)) * erf_inv(u)
