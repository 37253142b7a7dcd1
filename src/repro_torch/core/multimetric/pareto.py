"""Pareto dominance + hypervolume (minimization convention throughout).

Small, exact, numpy-only utilities: the tuner tracks the non-dominated set
of completed trials (``TuningResult.pareto_front``) and the benchmark/tests
score fronts by dominated hypervolume. Sizes here are trial counts (tens to
hundreds), so the simple O(n²) dominance scan and the HSO-style recursive
hypervolume are the right tools — no approximation enters the contract.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["pareto_mask", "hypervolume"]


def pareto_mask(y: np.ndarray) -> np.ndarray:
    """Boolean mask of the non-dominated rows of ``y`` (n, k), minimizing
    every column. Row a dominates row b iff a ≤ b everywhere and a < b
    somewhere; duplicates of a non-dominated point are all kept (neither
    strictly dominates the other)."""
    y = np.asarray(y, dtype=np.float64)
    if y.ndim != 2:
        raise ValueError(f"expected (n, k) array, got shape {y.shape}")
    n = y.shape[0]
    mask = np.ones(n, dtype=bool)
    for i in range(n):
        if not mask[i]:  # already dominated — cannot dominate anything new
            continue
        # knock out every row that row i dominates (row i itself fails the
        # strict `any <` test, so it survives its own pass)
        dominated = np.all(y >= y[i], axis=1) & np.any(y > y[i], axis=1)
        mask &= ~dominated
    return mask


def _hv_recursive(pts: np.ndarray, ref: np.ndarray) -> float:
    """Hypervolume by slicing objectives (HSO): slice along the first
    coordinate, recurse on the remainder. ``pts`` is non-dominated and
    sorted ascending by column 0; every point is ≤ ref elementwise."""
    if pts.shape[1] == 1:
        return float(ref[0] - pts[0, 0])  # sorted: row 0 is the minimum
    total = 0.0
    for i in range(pts.shape[0]):
        # slab between this point's first coordinate and the next one's
        hi = ref[0] if i + 1 == pts.shape[0] else pts[i + 1, 0]
        width = hi - pts[i, 0]
        if width <= 0.0:
            continue
        # points active in this slab: the first i+1 (sorted by column 0)
        sub = pts[: i + 1, 1:]
        keep = pareto_mask(sub)
        sub = sub[keep]
        order = np.argsort(sub[:, 0], kind="stable")
        total += width * _hv_recursive(sub[order], ref[1:])
    return total


def hypervolume(y: np.ndarray, ref: Optional[np.ndarray] = None) -> float:
    """Dominated hypervolume of point set ``y`` (n, k) w.r.t. reference
    point ``ref`` (k,), minimizing every column: the Lebesgue measure of
    ``{z : ∃ p ∈ y, p ≤ z ≤ ref}``. Points not strictly below ``ref`` in
    every coordinate contribute nothing. ``ref=None`` uses the nadir of
    ``y`` plus a unit margin (handy for tests; real comparisons should fix
    the reference)."""
    y = np.asarray(y, dtype=np.float64)
    if y.ndim != 2:
        raise ValueError(f"expected (n, k) array, got shape {y.shape}")
    if y.shape[0] == 0:
        return 0.0
    if ref is None:
        ref = y.max(axis=0) + 1.0
    ref = np.asarray(ref, dtype=np.float64)
    if ref.shape != (y.shape[1],):
        raise ValueError(f"ref shape {ref.shape} != ({y.shape[1]},)")
    below = np.all(y < ref, axis=1)
    y = y[below]
    if y.shape[0] == 0:
        return 0.0
    y = y[pareto_mask(y)]
    order = np.argsort(y[:, 0], kind="stable")
    return _hv_recursive(y[order], ref)
