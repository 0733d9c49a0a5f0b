"""JAX's threefry PRNG and the initializers flax draws from, in numpy.

The trained checkpoints hold only the trained parts of a probe; the frozen
backbone (and upsampler) come from ``model.init(jax.random.PRNGKey(0), ...)``
(``evaluate.py:load_model_for_eval``). This module reproduces that stream
without JAX, so that the port can rebuild the same frozen trees:

* ``threefry2x32``, ``prng_key``, ``fold_in``, ``split`` and ``bits32`` equal
  ``jax.random``'s bit for bit, under the default
  ``jax_threefry_partitionable=True``: the counter of element ``i`` is the
  uint64 ``i`` split into (hi, lo) words, and 32-bit bits are ``b1 ^ b2``;
* ``uniform``, ``normal`` and ``truncated_normal`` follow ``jax.random``'s
  float32 arithmetic step by step, XLA's fused multiply-adds included.
  ``erf_inv`` is XLA's float32 polynomial (Giles), whose only inexact part
  against XLA is ``log1p``: results lie within two ulp of JAX's;
* ``flax_param_key`` is the key flax hands a param's init function
  (``flax/core/scope.py``: ``_fold_in_static`` of the scope path and the
  scope's call counter, with no separator between the parts);
* ``lecun_normal``, ``xavier_uniform``, ``truncated_normal_init`` and
  ``normal_init`` are flax's default initializers
  (``jax.nn.initializers.variance_scaling``).

Keys are ``uint32[2]`` numpy arrays (JAX's raw ``PRNGKey`` layout).
"""

from __future__ import annotations

import hashlib
import math
from typing import Sequence, Tuple, Union

import numpy as np

__all__ = ["threefry2x32", "prng_key", "fold_in", "split", "bits32",
           "uniform", "erf_inv", "normal", "truncated_normal",
           "flax_param_key", "lecun_normal", "xavier_uniform",
           "truncated_normal_init", "normal_init", "TRUNC2_ERF"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32 = np.float32
_SQRT2 = np.float32(np.sqrt(2))

# float32 erf(-2/sqrt(2)) and erf(2/sqrt(2)) as XLA computes them: the
# uniform range of jax.random.truncated_normal(key, -2, 2) (held against
# JAX in tests/test_torch_jax_rng.py)
TRUNC2_ERF = (np.float32(-0.9544997), np.float32(0.9544997))

# XLA's float32 erf_inv (Giles, "Approximating the erfinv function"),
# coefficients for w = -log1p(-x^2) below and above 5
_ERFINV_LT5 = tuple(np.float32(c) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941))
_ERFINV_GE5 = tuple(np.float32(c) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray,
                 x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds on counter words ``(x0, x1)`` (uint32
    arrays of one shape) under ``key``; JAX's ``threefry2x32_p``."""
    k0, k1 = (np.uint32(k) for k in np.asarray(key, np.uint32))
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    v0 = np.asarray(x0, np.uint32) + ks[0]
    v1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            v0 += v1
            v1 = _rotl(v1, r)
            v1 ^= v0
        v0 += ks[(i + 1) % 3]
        v1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return v0, v1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for ``0 <= seed < 2**32``."""
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    return np.array([0, seed], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([data], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def _counters(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The (hi, lo) words of the uint64 counters 0..n-1."""
    i = np.arange(n, dtype=np.uint64)
    return ((i >> np.uint64(32)).astype(np.uint32),
            (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``uint32[num, 2]``."""
    b0, b1 = threefry2x32(key, *_counters(num))
    return np.stack([b0, b1], axis=-1)


def bits32(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)``."""
    b0, b1 = threefry2x32(key, *_counters(math.prod(shape)))
    return (b0 ^ b1).reshape(shape)


def uniform(key: np.ndarray, shape: Sequence[int], minval=0.0,
            maxval=1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled into ``[minval, maxval)``. XLA fuses
    the scaling into one fused multiply-add, computed here in float64 (the
    product of two float32 values is exact there)."""
    lo, hi = _F32(minval), _F32(maxval)
    fbits = (bits32(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = fbits.view(np.float32) - _F32(1.0)
    scaled = floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)
    return np.maximum(lo, scaled.astype(np.float32))


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv`` on ``[-1, 1]``: the Horner steps are fused
    multiply-adds (float64 products of float32 values, rounded once), and
    ``log1p`` is numpy's, which can differ from XLA's by one ulp."""
    x = np.asarray(x, np.float32)
    w = -np.log1p(-x * x)
    lt = w < _F32(5.0)
    w = np.where(lt, w - _F32(2.5), np.sqrt(w) - _F32(3.0))
    w = w.astype(np.float64)
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        # one fused multiply-add a step, as XLA emits it
        p = (np.where(lt, c_lt, c_ge).astype(np.float64)
             + p.astype(np.float64) * w).astype(np.float32)
    out = p * x
    return np.where(np.abs(x) == _F32(1.0),
                    x * np.finfo(np.float32).max, out).astype(np.float32)


def normal(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal`` in float32: sqrt(2)·erf_inv of a uniform on
    (-1, 1)."""
    lo = np.nextafter(_F32(-1.0), _F32(0.0))
    return _SQRT2 * erf_inv(uniform(key, shape, lo, _F32(1.0)))


def truncated_normal(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.truncated_normal(key, -2, 2, shape)`` in float32: the
    erf-bounded uniform through sqrt(2)·erf_inv, clipped inside (-2, 2)."""
    out = _SQRT2 * erf_inv(uniform(key, shape, *TRUNC2_ERF))
    return np.clip(out, np.nextafter(_F32(-2.0), _F32(np.inf)),
                   np.nextafter(_F32(2.0), _F32(-np.inf)))


def flax_param_key(root: np.ndarray, path: Sequence[Union[str, int]],
                   counter: int) -> np.ndarray:
    """The key flax passes to the init function of a param declared in the
    scope at ``path`` (module names from ``root``'s scope down), as that
    scope's ``counter``-th ``make_rng('params')`` call (counted from 1)."""
    m = hashlib.sha1()
    for part in (*path, counter):
        if isinstance(part, str):
            m.update(part.encode("utf-8"))
        else:
            m.update(int(part).to_bytes((int(part).bit_length() + 7) // 8,
                                        "big"))
    return fold_in(root, int.from_bytes(m.digest()[:4], "big"))


def _fans(shape: Sequence[int]) -> Tuple[int, int]:
    """flax's fans: in axis -2, out axis -1, the rest receptive field."""
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def lecun_normal(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """flax's default Dense/Conv kernel init: a (-2, 2)-truncated normal of
    variance 1/fan_in."""
    variance = _F32(1.0 / _fans(shape)[0])
    stddev = np.sqrt(variance) / _F32(.87962566103423978)
    return truncated_normal(key, shape) * stddev


def xavier_uniform(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``nn.initializers.xavier_uniform()``: uniform on (-1, 1) scaled by
    sqrt(3 / fan_avg)."""
    fan_in, fan_out = _fans(shape)
    variance = _F32(1.0 / ((fan_in + fan_out) / 2))
    return uniform(key, shape, -1.0, 1.0) * np.sqrt(_F32(3) * variance)


def truncated_normal_init(stddev: float):
    """``nn.initializers.truncated_normal(stddev)`` (bounds -2, 2)."""
    def init(key, shape):
        return truncated_normal(key, shape) * _F32(stddev)
    return init


def normal_init(stddev: float):
    """``nn.initializers.normal(stddev)``."""
    def init(key, shape):
        return normal(key, shape) * _F32(stddev)
    return init
