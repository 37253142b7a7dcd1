"""Tabulated blackbox surfaces: the optimizer-quality test harness.

Real AMT benchmarks (paper §6) replay *pre-recorded* tuning surfaces —
config grid → (learning curve, wall-clock cost, metrics) tables — through a
simulated clock, so an optimizer change is judged on what it would have
spent and found, deterministically and in milliseconds. This module is that
harness for this repo:

  * ``BlackboxTable`` — an immutable (config-grid → curve, cost, metrics)
    table with nearest-neighbor lookup in the *encoded* unit cube (the same
    [0,1]^d image the GP models, so "nearest" respects log/int scalings).
    Tables round-trip through plain JSON for shipping recorded surfaces.
  * ``TabulatedBackend`` — a ``SimBackend`` that evaluates every submitted
    trial from the table instead of calling user code: the discrete-event
    clock, startup cost, per-iteration curve replay, and failure injection
    all behave exactly as they do for a live objective.
  * two built-in toy surfaces (``quadratic_table``,
    ``deceptive_cheap_table``) sized for sub-minute CI quality gates. The
    deceptive table is the cost-aware acceptance surface: its global
    optimum lives in the *cheap* region while a nearly-as-deep basin costs
    ~10× more — a cost-blind EI happily burns budget in the expensive
    basin, EI-per-unit-cost should not.

The harness is pure replay: no wall clock, no RNG at evaluation time (grid
construction seeds are explicit), so quality-gate assertions can pin exact
thresholds per seed.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.scheduler import SimBackend, Trial
from repro_torch.core.search_space import Continuous, SearchSpace

__all__ = [
    "BlackboxTable",
    "TabulatedBackend",
    "quadratic_table",
    "deceptive_cheap_table",
]


class BlackboxTable:
    """A recorded blackbox: N grid configs, each with a T-point objective
    curve, a per-iteration cost, and optional named final metrics.

    Args:
        space: the search space the grid lives in (lookup encodes queries
            through it).
        grid: (N, d) float64 — *encoded* grid configs (unit cube).
        curves: (N, T) float64 — objective curves, minimize convention.
        costs: (N,) or (N, T) float64 — simulated seconds; a (N,) vector
            means "evenly spread over the T iterations" (total cost is the
            recorded trial cost either way).
        metrics: optional ``{name: (N,) float64}`` final metric columns
            (multi-metric jobs read these off the completion event).
    """

    def __init__(
        self,
        space: SearchSpace,
        grid: np.ndarray,
        curves: np.ndarray,
        costs: np.ndarray,
        metrics: Optional[Dict[str, np.ndarray]] = None,
    ):
        self.space = space
        self.grid = np.asarray(grid, dtype=np.float64)
        self.curves = np.asarray(curves, dtype=np.float64)
        costs = np.asarray(costs, dtype=np.float64)
        n, t = self.curves.shape
        if self.grid.shape != (n, space.encoded_dim):
            raise ValueError(
                f"grid shape {self.grid.shape} != ({n}, {space.encoded_dim})"
            )
        if costs.ndim == 1:
            if costs.shape != (n,):
                raise ValueError(f"costs shape {costs.shape} != ({n},)")
            costs = np.repeat(costs[:, None] / t, t, axis=1)
        elif costs.shape != (n, t):
            raise ValueError(f"costs shape {costs.shape} != ({n}, {t})")
        self.costs = costs
        self.metrics = {
            k: np.asarray(v, dtype=np.float64) for k, v in (metrics or {}).items()
        }
        for k, v in self.metrics.items():
            if v.shape != (n,):
                raise ValueError(f"metric {k!r} shape {v.shape} != ({n},)")

    # ------------------------------------------------------------ inspection
    @property
    def num_configs(self) -> int:
        return self.curves.shape[0]

    @property
    def num_iterations(self) -> int:
        return self.curves.shape[1]

    def best_value(self) -> float:
        """The table's global optimum (min over all curve points)."""
        return float(self.curves.min())

    def total_cost(self, row: int) -> float:
        """Recorded total cost of one grid config's full curve."""
        return float(self.costs[row].sum())

    # -------------------------------------------------------------- lookup
    def lookup(self, config: Mapping[str, Any]) -> int:
        """Row index of the grid config nearest to ``config`` — L2 in the
        encoded unit cube, so distance respects each parameter's scaling."""
        q = self.space.encode(config)
        return int(np.argmin(np.sum((self.grid - q[None, :]) ** 2, axis=1)))

    def objective(self, config: Mapping[str, Any]):
        """``SimBackend``-shaped evaluation: (curve, per-iteration costs)
        or (curve, costs, metrics) of the nearest grid config."""
        row = self.lookup(config)
        values = self.curves[row].tolist()
        costs = self.costs[row].tolist()
        if self.metrics:
            return values, costs, {k: float(v[row]) for k, v in self.metrics.items()}
        return values, costs

    # ---------------------------------------------------------------- wire
    def to_json(self) -> str:
        """Plain-JSON image (grids as nested lists — tables are shipped
        artifacts, not hot-path state, so readability wins over bytes)."""
        return json.dumps(
            {
                "space": self.space.to_spec(),
                "grid": self.grid.tolist(),
                "curves": self.curves.tolist(),
                "costs": self.costs.tolist(),
                "metrics": {k: v.tolist() for k, v in self.metrics.items()},
            }
        )

    @classmethod
    def from_json(cls, blob: str) -> "BlackboxTable":
        obj = json.loads(blob)
        return cls(
            SearchSpace.from_spec(obj["space"]),
            np.asarray(obj["grid"]),
            np.asarray(obj["curves"]),
            np.asarray(obj["costs"]),
            metrics={k: np.asarray(v) for k, v in obj.get("metrics", {}).items()},
        )


class TabulatedBackend(SimBackend):
    """A ``SimBackend`` whose evaluations come from a ``BlackboxTable``.

    Drop-in for ``SimBackend`` in ``Tuner(...)``: the discrete-event clock,
    startup cost, curve replay, and failure injection are inherited
    unchanged — only the objective is replaced by table lookup, so the
    objective callable handed to ``submit`` is ignored (pass
    ``table.objective`` or a stub to the Tuner). ``evaluations`` counts
    lookups, letting benchmarks assert equal trial budgets across arms.
    """

    def __init__(self, table: BlackboxTable, startup_cost: float = 0.0,
                 failure_fn=None):
        super().__init__(startup_cost=startup_cost, failure_fn=failure_fn)
        self.table = table
        self.evaluations = 0

    def submit(self, trial: Trial, objective: Callable = None) -> None:
        self.evaluations += 1
        super().submit(trial, self.table.objective)


# --------------------------------------------------------------------------
# built-in toy surfaces
# --------------------------------------------------------------------------


def _toy_space() -> SearchSpace:
    return SearchSpace(
        [Continuous("x", 0.0, 1.0), Continuous("y", 0.0, 1.0)]
    )


def _curve_to(final: np.ndarray, t: int) -> np.ndarray:
    """Exponentially-converging learning curves ending at ``final``:
    value_i = final + (2 − final)·exp(−3·i/(T−1))·… simplified so the last
    point is exactly ``final`` and early points overshoot it."""
    i = np.arange(t, dtype=np.float64)
    decay = np.exp(-4.0 * i / max(t - 1, 1))
    decay = (decay - decay[-1]) / (decay[0] - decay[-1])  # 1 → 0 exactly
    return final[:, None] + 2.0 * decay[None, :]


def quadratic_table(
    grid_side: int = 24, num_iterations: int = 5, seed: int = 0
) -> BlackboxTable:
    """A benign quadratic bowl on [0,1]²: optimum at (0.7, 0.3), cost mildly
    increasing with x. The BO-vs-random quality-gate surface: smooth, no
    deception, a GP should crush random search on it."""
    space = _toy_space()
    g = (np.arange(grid_side) + 0.5) / grid_side
    xx, yy = np.meshgrid(g, g, indexing="ij")
    pts = np.stack([xx.ravel(), yy.ravel()], axis=1)  # (N, 2) == encoded
    rng = np.random.default_rng(seed)  # invariant: fresh-rng -- table noise is a pure function of the seed argument, built once here; no generator state outlives the constructor
    final = (
        4.0 * (pts[:, 0] - 0.7) ** 2
        + 4.0 * (pts[:, 1] - 0.3) ** 2
        + 0.01 * rng.standard_normal(len(pts))
    )
    curves = _curve_to(final, num_iterations)
    costs = 1.0 + 2.0 * pts[:, 0]
    return BlackboxTable(space, pts, curves, costs)


def deceptive_cheap_table(
    grid_side: int = 24, num_iterations: int = 5, seed: int = 0
) -> BlackboxTable:
    """The cost-aware acceptance surface: two basins on [0,1]².

    * **cheap basin** at (0.2, 0.2) — the *global* optimum (depth −1.0),
      cost ≈ 1 per trial;
    * **expensive basin** at (0.8, 0.8) — nearly as deep (−0.92), cost ≈ 10
      per trial.

    A cost-blind EI sees two nearly-equal basins and spends real budget
    resolving the expensive one; EI-per-unit-cost discounts it by e^{−η·ẑc}
    and converges on the cheap optimum at a fraction of the simulated
    spend. The quality gate and ``benchmarks/cost_aware.py`` assert exactly
    that separation.
    """
    space = _toy_space()
    g = (np.arange(grid_side) + 0.5) / grid_side
    xx, yy = np.meshgrid(g, g, indexing="ij")
    pts = np.stack([xx.ravel(), yy.ravel()], axis=1)
    rng = np.random.default_rng(seed)  # invariant: fresh-rng -- table noise is a pure function of the seed argument, built once here; no generator state outlives the constructor
    d_cheap = np.sum((pts - np.array([0.2, 0.2])) ** 2, axis=1)
    d_exp = np.sum((pts - np.array([0.8, 0.8])) ** 2, axis=1)
    # broad basins (radius ~0.28): a handful of random inits see the slope,
    # and the shared-factor lengthscales stay long enough for the cost head
    # to generalize the cost gradient away from observed points.
    final = (
        1.0
        - 2.0 * np.exp(-d_cheap / 0.08)  # global optimum, depth −1.0
        - 1.93 * np.exp(-d_exp / 0.08)  # runner-up, depth −0.93
        + 0.01 * rng.standard_normal(len(pts))
    )
    curves = _curve_to(final, num_iterations)
    # cost grows smoothly toward the expensive corner: ~1 near (0.2, 0.2),
    # ~10 near (0.8, 0.8) — the cost head can *learn* it from few trials.
    corner = np.clip((pts[:, 0] + pts[:, 1] - 0.4) / 1.2, 0.0, 1.0)
    costs = 1.0 + 9.0 * corner**2
    return BlackboxTable(space, pts, curves, costs)
