"""Counter-based threefry2x32 keys and draws, as ``jax.random`` makes them.

The engine's decisions depend on every random draw: the slice sampler's
directions, slice levels and shrink points (``gp/slice_sampler.py``) and the
Thompson draws of ``optimize_acq.py``. The JAX package takes them from
``jax.random`` threefry keys. To make the same decisions, and to load a JAX
engine's ``state_dict`` unchanged, the port reproduces that key stream here,
on the host, in integer numpy:

* ``PRNGKey``, ``split`` and ``random_bits`` are integer arithmetic and are
  bit-exact against ``jax.random`` with ``threefry2x32`` and
  ``jax_threefry_partitionable=True`` (jax 0.9.0's default);
* ``uniform`` builds floats from those bits exactly as JAX does, so it is
  exact too;
* ``normal`` (√2·erfinv) and ``exponential`` (−log1p(−u)) apply a
  transcendental; XLA's CPU ``erf_inv`` and ``log1p`` are polynomial
  approximations, so they agree to within a few hundred ulp.

Keys are (2,) uint32 arrays and are passed explicitly, as in the reference.
Draws are float64 numpy (the engine's dtype); callers move them to a device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "PRNGKey",
    "split",
    "random_bits",
    "uniform",
    "normal",
    "exponential",
    "threefry2x32",
]

_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(
    k1: np.uint32, k2: np.uint32, x1: np.ndarray, x2: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 block function (20 rounds) on uint32 counter pairs."""
    k1 = np.uint32(k1)
    k2 = np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [np.asarray(x1, np.uint32).copy(), np.asarray(x2, np.uint32).copy()]
    with np.errstate(over="ignore"):
        x[0] = x[0] + ks[0]
        x[1] = x[1] + ks[1]
        for i in range(5):
            for r in _ROT0 if i % 2 == 0 else _ROT1:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r)
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:
    """Legacy ``jax.random.PRNGKey``: the 64-bit seed as (hi, lo) uint32."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & 0xFFFFFFFF], dtype=np.uint32)


def _counters(num: int) -> tuple[np.ndarray, np.ndarray]:
    """Partitionable iota: a uint64 count as (hi, lo) uint32 halves."""
    c = np.arange(num, dtype=np.uint64)
    return (c >> np.uint64(32)).astype(np.uint32), c.astype(np.uint32)


def _as_key(key) -> np.ndarray:
    k = np.asarray(key, dtype=np.uint32)
    if k.shape != (2,):
        raise ValueError(f"expected one (2,) uint32 key, got shape {k.shape}")
    return k


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split``: (num, 2) uint32 keys."""
    k = _as_key(key)
    hi, lo = _counters(num)
    b1, b2 = threefry2x32(k[0], k[1], hi, lo)
    return np.stack([b1, b2], axis=1)


def random_bits(key, shape=()) -> np.ndarray:
    """64-bit raw draws of ``shape`` (what 64-bit floats are made from)."""
    k = _as_key(key)
    shape = tuple(shape)
    size = int(np.prod(shape)) if shape else 1
    hi, lo = _counters(size)
    b1, b2 = threefry2x32(k[0], k[1], hi, lo)
    bits = (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)
    return bits.reshape(shape)


def uniform(key, shape=(), minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform`` in float64: mantissa bits under exponent 0,
    minus one, scaled, floored at ``minval``."""
    bits = random_bits(key, shape)
    float_bits = (bits >> np.uint64(64 - 52)) | np.float64(1.0).view(np.uint64)
    floats = float_bits.view(np.float64) - 1.0
    lo = np.float64(minval)
    hi = np.float64(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def normal(key, shape=()) -> np.ndarray:
    """``jax.random.normal`` in float64: √2·erfinv(u), u ∈ (−1, 1)."""
    lo = np.nextafter(np.float64(-1.0), np.float64(0.0))
    u = uniform(key, shape, lo, 1.0)
    e = torch.special.erfinv(torch.from_numpy(np.asarray(u, np.float64)))
    return np.float64(np.sqrt(2.0)) * e.numpy()


def exponential(key, shape=()) -> np.ndarray:
    """``jax.random.exponential`` in float64: −log1p(−u)."""
    u = uniform(key, shape)
    return -np.log1p(-u)
