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
  transcendental. They evaluate the same float64 formulas as XLA's CPU
  backend (its ``log1p`` and ``erf_inv`` polynomials, written out below in
  numpy), so they agree with ``jax.random`` to within 4 ulp, far tail
  included; a correctly rounded ``erfinv`` would sit thousands of ulp from
  XLA's there.

Keys are (2,) uint32 arrays and are passed explicitly, as in the reference.
Draws are float64 numpy (the engine's dtype); callers move them to a device.
"""

from __future__ import annotations

import numpy as np

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


# XLA's float64 log1p (its CPU elemental emitter): Cephes' rational form
# x − x²/2 + x³·P(x)/Q(x) for |x| < √2 − 1, log(1 + x) otherwise.
# Coefficients highest degree first; Q is monic.
_LOG1P_P = (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1,
)
_LOG1P_Q = (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1,
)

# XLA's float64 erf_inv: M. Giles, "Approximating the erfinv function" (GPU
# Computing Gems, 2011), three polynomials in w = −log1p(−x²), highest
# degree first: in w − 3.125 for w < 6.25, √w − 3.25 for w < 16, √w − 5
# beyond.
_ERFINV_W_LT_6_25 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356,
)
_ERFINV_W_LT_16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635,
)
_ERFINV_W_GE_16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221,
)


def _horner(coeffs, x: np.ndarray) -> np.ndarray:
    p = np.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = p * x + c
    return p


def _log1p(x: np.ndarray) -> np.ndarray:
    """log(1 + x) as XLA's CPU backend evaluates it in float64."""
    x = np.asarray(x, np.float64)
    x2 = x * x
    small = x + (-0.5 * x2 + (x * x2) * (_horner(_LOG1P_P, x) / _horner(_LOG1P_Q, x)))
    with np.errstate(divide="ignore", invalid="ignore"):
        large = np.log(x + 1.0)
    return np.where(np.abs(x) < 0.41421356237309504880, small, large)


def _erf_inv(x: np.ndarray) -> np.ndarray:
    """erf⁻¹(x) for x ∈ (−1, 1) as XLA evaluates it in float64."""
    x = np.asarray(x, np.float64)
    w = -_log1p(-x * x)
    p = np.where(
        w < 6.25,
        _horner(_ERFINV_W_LT_6_25, w - 3.125),
        np.where(
            w < 16.0,
            _horner(_ERFINV_W_LT_16, np.sqrt(w) - 3.25),
            _horner(_ERFINV_W_GE_16, np.sqrt(w) - 5.0),
        ),
    )
    return p * x


def normal(key, shape=()) -> np.ndarray:
    """``jax.random.normal`` in float64: √2·erfinv(u), u ∈ (−1, 1)."""
    lo = np.nextafter(np.float64(-1.0), np.float64(0.0))
    u = uniform(key, shape, lo, 1.0)
    return np.float64(np.sqrt(2.0)) * _erf_inv(u)


def exponential(key, shape=()) -> np.ndarray:
    """``jax.random.exponential`` in float64: −log1p(−u)."""
    u = uniform(key, shape)
    return -_log1p(-u)
