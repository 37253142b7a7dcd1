"""Sobol low-discrepancy sequences (paper §2.1, §4.3).

AMT uses Sobol points in two places:
  1. as a quasi-random *search strategy* alternative to random search, and
  2. as the dense anchor grid for Thompson-style sampling and for initializing
     the local optimization of the EI acquisition function (§4.3: "The set is
     obtained through a Sobol sequence generator populating the search space as
     densely as possible").

Implementation: standard Gray-code construction (Bratley & Fox / Joe & Kuo)
with 30-bit resolution and the Joe-Kuo "new-joe-kuo-6" direction numbers for
the first 160 dimensions (statically embedded in ``_sobol_data``). Optionally
Owen-style digital shift ("scrambling-lite") so repeated BO runs do not reuse
the exact same anchors — the paper notes Sobol points "are deterministic",
which is desirable for reproducibility but can be varied via ``shift_rng``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core._sobol_data import MAX_DIM, POLY, VINIT

__all__ = ["SobolSequence", "sobol_sample"]

_MAXBIT = 30
_SCALE = np.float64(2.0**-_MAXBIT)


def _direction_numbers(dim: int) -> np.ndarray:
    """Compute v[dim, _MAXBIT] direction numbers (already bit-shifted)."""
    if dim > MAX_DIM:
        raise ValueError(f"Sobol table supports up to {MAX_DIM} dims, got {dim}")
    v = np.zeros((dim, _MAXBIT), dtype=np.uint64)
    # Dimension 0: van der Corput in base 2 -> m_k = 1 for all k.
    v[0, :] = 1
    for j in range(1, dim):
        poly = int(POLY[j])
        s = poly.bit_length() - 1  # degree of the primitive polynomial
        # inner coefficient bits a_1..a_{s-1} (mask off leading+trailing 1s)
        a = [(poly >> (s - i)) & 1 for i in range(1, s)]
        m = [int(x) for x in VINIT[j][:s]]
        for k in range(_MAXBIT):
            if k < s:
                v[j, k] = m[k]
            else:
                newv = int(v[j, k - s]) ^ (int(v[j, k - s]) << s)
                for i in range(1, s):
                    if a[i - 1]:
                        newv ^= int(v[j, k - i]) << i
                # note: construction above is in the "m_k" (unshifted) domain
                v[j, k] = newv
    # shift m_k into the top bits: v_k = m_k * 2^(MAXBIT - k - 1)
    shifts = (np.uint64(_MAXBIT) - np.arange(1, _MAXBIT + 1, dtype=np.uint64))
    return v << shifts[None, :]


class SobolSequence:
    """Stateful Sobol generator over [0, 1)^dim.

    >>> s = SobolSequence(3)
    >>> pts = s.next(8)   # (8, 3) float64, first point is the origin
    """

    def __init__(self, dim: int, shift_rng: Optional[np.random.Generator] = None):
        if dim < 1:
            raise ValueError("dim must be >= 1")
        self.dim = dim
        self._v = _direction_numbers(dim)  # (dim, MAXBIT) uint64
        self._state = np.zeros(dim, dtype=np.uint64)
        self._count = 0
        if shift_rng is not None:
            self._shift = shift_rng.integers(
                0, 1 << _MAXBIT, size=dim, dtype=np.uint64
            )
        else:
            self._shift = np.zeros(dim, dtype=np.uint64)

    def next(self, n: int) -> np.ndarray:
        """Return the next ``n`` points, shape (n, dim)."""
        out = np.empty((n, self.dim), dtype=np.float64)
        state = self._state
        for i in range(n):
            if self._count == 0:
                # first point of the unshifted sequence is the origin
                out[i] = (state ^ self._shift) * _SCALE
                self._count = 1
                continue
            # Gray-code index: lowest zero bit of (count - 1)
            c = _lowest_zero_bit(self._count - 1)
            if c >= _MAXBIT:
                raise RuntimeError("Sobol sequence exhausted (2^30 points)")
            state = state ^ self._v[:, c]
            out[i] = (state ^ self._shift) * _SCALE
            self._count += 1
        self._state = state
        return out

    def reset(self) -> None:
        self._state = np.zeros(self.dim, dtype=np.uint64)
        self._count = 0


def _lowest_zero_bit(x: int) -> int:
    c = 0
    while x & 1:
        x >>= 1
        c += 1
    return c


def sobol_sample(
    dim: int, n: int, shift_rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Convenience: the first ``n`` Sobol points in [0,1)^dim, shape (n, dim)."""
    return SobolSequence(dim, shift_rng=shift_rng).next(n)
