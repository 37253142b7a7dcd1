"""Large-n posterior support: deterministic inducing-row selection.

The engine's exact posterior costs O(S·n²) per rank-1 append and pins
O(S·n²) of resident L/L⁻¹ — fine to n ≈ 10³, dominant well before the
pooled histories sibling warm-start and Autopilot-style fleets produce
(n ≈ 10⁵). The ``"subset"`` posterior backend (``BOConfig.posterior_backend``)
caps the factor at m ≲ ``max_inducing`` rows: a subset-of-regressors /
Nyström-style approximation whose *factor* is just the exact GP over the m
selected store rows, so every piece of the incremental machinery — rank-1
appends, blocked appends, ``refresh_alpha``, ``grow_posterior``, the fused
anchor-scoring kernel, the shared-factor multi-head layout — operates on it
unchanged; only which store rows are live differs.

This module holds the one new primitive: **greedy max-diversity (farthest-
point) selection** of the inducing rows. Properties the engine contract
leans on:

* **X-only.** Selection never reads targets, so history *corrections*
  (objective rewrites) leave the inducing set — and therefore the cached
  factors — valid, exactly like the exact backend.
* **Deterministic and RNG-free.** Seeded at row 0, ties broken by lowest
  row index (``np.argmax`` returns the first maximum). Re-running the
  selection over the same store prefix reproduces the same set bit-exactly,
  which is what lets arena eviction, engine snapshots, and remote failover
  *replay* the inducing-set construction instead of shipping it — the same
  replay-rehydration invariant the exact backend's factors rely on.
* **Boundary-anchored.** The engine selects only at refit/adoption
  boundaries (over the immutable store prefix ``[0, r)``); rows arriving
  between boundaries are appended to the factor as ordinary rank-1 borders.
  A rebuild therefore recomputes the identical set from ``(r,)`` alone.

Complexity: O(m·n·d) time, O(n) scratch — vectorized over the store, so
selecting 1024 rows from 10⁵ is a numpy sweep, not a Python loop over pairs.

This is the JAX package's selection, copied: the same numpy operations in
the same order, so both packages pick the same rows bit for bit (a torch
reduction over d could round a distance differently and turn a near-tie
of ``argmax`` into another row). It stays on the host for that reason.
"""

from __future__ import annotations

import numpy as np

__all__ = ["select_inducing"]


def select_inducing(x: np.ndarray, m: int) -> np.ndarray:
    """Pick ``min(m, n)`` inducing rows from ``x`` (n, d) by greedy
    farthest-point traversal in squared L2, returned as **sorted** int64
    store-row indices.

    Row 0 seeds the traversal; each step adds the row farthest from the
    current set (first index on ties — deterministic). Sorting the result
    keeps the live-row layout in store order, so gathered targets and the
    appended tail read naturally.
    """
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    if m <= 0:
        raise ValueError(f"need at least one inducing row, got m={m}")
    if n <= m:
        return np.arange(n, dtype=np.int64)
    sel = np.empty(m, dtype=np.int64)
    sel[0] = 0
    # running min squared distance to the selected set; selected rows are
    # clamped to -1 so duplicates of a selected row can never be re-picked.
    d2 = np.sum((x - x[0]) ** 2, axis=1)
    d2[0] = -1.0
    for i in range(1, m):
        j = int(np.argmax(d2))
        sel[i] = j
        d2 = np.minimum(d2, np.sum((x - x[j]) ** 2, axis=1))
        d2[j] = -1.0
    sel.sort()
    return sel
