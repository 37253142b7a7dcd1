"""Stateful observation store for the incremental BO decision engine.

The paper's asynchronous loop (§4.4) updates the surrogate the moment an
evaluation finishes and refills the freed slot. The seed implementation was
stateless: every decision re-encoded the full ``List[Tuple[dict, float]]``
history, so per-decision cost grew with the job instead of being amortized.
``ObservationStore`` is the event-sourced replacement:

  * encoded inputs live in a capacity-doubled (power-of-two bucketed) array,
    so the suggester can view them zero-copy and pad to the GP's shape bucket
    without rebuilding;
  * objectives stay resident, so the standardization the GP needs (paper
    §4.2: zero mean / unit std) is one numerically stable O(n) vector pass
    per decision — never a re-encode of the dict history;
  * warm-start parent observations (paper §5.3) are folded in **once** at
    construction, pre-encoded and per-task z-scored, instead of being decoded
    to dicts and re-encoded on every suggestion;
  * the pending set (configs submitted but not finished) is tracked by key so
    the §4.4 "never re-propose a pending candidate" rule and fantasizing
    strategies read it directly;
  * a monotone ``version`` lets a cached GP posterior discover exactly which
    rows were appended since it was factorized and apply rank-1 updates
    (see ``repro_torch.core.gp.incremental``) instead of refactorizing.

Rows are append-only and live rows always form a prefix, which is the
invariant the rank-1 Cholesky append relies on. (The one sanctioned
exception is ``delete_own`` — an explicit history correction — which shifts
the suffix up so the prefix invariant holds again immediately; the GP layer
mirrors it with a rank-1 Cholesky *downdate*.)

Multi-metric jobs (``repro_torch.core.multimetric``): constructed with a
``MetricSet`` of M metrics, the store grows an (n × M) Y block — column 0
(the primary objective) lives in the same ``_y`` array the single-metric
engine reads, so the M=1 case is byte-for-byte today's store; columns
1..M−1 live in a parallel ``_yx`` block with per-metric running
standardization. Warm-start parents carry objective values only, so parent
folding is refused for M > 1 (constraint heads cannot impute parent rows).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Hashable, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.search_space import SearchSpace

__all__ = ["ObservationStore", "bucket_size"]

Observation = Tuple[Mapping[str, Any], float]

_STD_FLOOR = 1e-12


def bucket_size(n: int, floor: int = 8) -> int:
    """Next power-of-two shape bucket ≥ n (jit recompiles stay logarithmic)."""
    b = floor
    while b < n:
        b *= 2
    return b


class ObservationStore:
    """Encoded (X, y) history + pending set for one tuning job.

    Layout: rows ``[0, num_parents)`` hold warm-start parent observations
    (y already z-scored per parent task); rows ``[num_parents, n)`` hold this
    job's own observations with raw objectives. ``standardized()`` reproduces
    the seed pipeline's values exactly: own rows are z-scored against each
    other when parents are present, then the combined vector is standardized
    to zero mean / unit std.
    """

    def __init__(
        self,
        space: SearchSpace,
        warm_start=None,
        capacity_floor: int = 8,
        metrics=None,
    ):
        self.space = space
        self.metrics = metrics  # Optional[MetricSet]; None ⇒ single metric
        m_extra = 0 if metrics is None else metrics.num_metrics - 1
        d = space.encoded_dim
        if warm_start is not None and getattr(warm_start, "num_parents", 0) > 0:
            if m_extra > 0:
                raise ValueError(
                    "warm-start parents carry objective values only; a "
                    "multi-metric store (M > 1) cannot fold them (no data "
                    "for the constraint/extra-objective heads)"
                )
            px, pz, _, _ = warm_start.export(space)
        else:
            px = np.zeros((0, d))
            pz = np.zeros((0,))
        self._num_parents = int(px.shape[0])
        cap = bucket_size(max(capacity_floor, self._num_parents))
        self._x = np.zeros((cap, d), dtype=np.float64)
        self._y = np.zeros((cap,), dtype=np.float64)
        # metric columns 1..M−1 (column 0 *is* ``_y``): own rows only.
        self._yx = np.zeros((cap, m_extra), dtype=np.float64)
        self._x[: self._num_parents] = px
        self._y[: self._num_parents] = pz
        self._n_own = 0
        # per-own-row caller keys (the Tuner passes trial ids): the binding
        # the multi-fidelity layer uses to join store rows with rung tables.
        # None for callers that don't track keys — the GP never reads them.
        self._own_keys: List[Optional[Hashable]] = []
        # per-own-row trial costs (simulated seconds, from backend event
        # times). None for cost-less callers; the list stays all-None — and
        # every serialized form omits it — unless a cost is ever pushed, so
        # cost-off jobs serialize byte-identically to the pre-cost store.
        self._own_costs: List[Optional[float]] = []
        self._pending: Dict[Hashable, Tuple[Dict[str, Any], np.ndarray]] = {}

    # ------------------------------------------------------------- counters
    @property
    def num_parents(self) -> int:
        return self._num_parents

    @property
    def num_own(self) -> int:
        return self._n_own

    @property
    def num_observations(self) -> int:
        """Total rows (parents + own). Doubles as the store ``version``: rows
        are append-only, so this value identifies the X prefix exactly."""
        return self._num_parents + self._n_own

    @property
    def version(self) -> int:
        return self.num_observations

    @property
    def num_pending(self) -> int:
        return len(self._pending)

    @property
    def num_metrics(self) -> int:
        return 1 if self.metrics is None else self.metrics.num_metrics

    # ------------------------------------------------------------ mutation
    def push(
        self,
        config: Mapping[str, Any],
        y: float,
        key: Optional[Hashable] = None,
        cost: Optional[float] = None,
    ) -> bool:
        """Append one finished observation. Non-finite objectives are dropped
        (they must neither seed the GP nor shift the standardization).
        ``key`` (optional) tags the row with the caller's trial id — the
        join handle of the multi-fidelity rung tables. ``cost`` (optional)
        records the trial's simulated cost for the cost head."""
        return self.push_encoded(self.space.encode(config), y, key=key, cost=cost)

    def push_encoded(
        self,
        x: np.ndarray,
        y: float,
        key: Optional[Hashable] = None,
        cost: Optional[float] = None,
    ) -> bool:
        if self.num_metrics > 1:
            raise ValueError(
                "multi-metric store: push the full metric vector "
                "(push_metrics / push_vector_encoded), not a bare objective"
            )
        y = float(y)
        if not math.isfinite(y):
            return False
        n = self.num_observations
        if n >= self._x.shape[0]:
            self._grow(bucket_size(n + 1))
        self._x[n] = x
        self._y[n] = y
        self._n_own += 1
        self._own_keys.append(key)
        self._own_costs.append(None if cost is None else float(cost))
        return True

    def push_metrics(
        self,
        config: Mapping[str, Any],
        values: Mapping[str, float],
        key: Optional[Hashable] = None,
    ) -> bool:
        """Append one finished observation from a named metric dict (signed
        through the ``MetricSet`` into the engine's minimize convention).
        Raises ``KeyError`` on a missing metric name; any non-finite metric
        value drops the whole row (a partial row would shift one head's
        standardization against the others)."""
        if self.metrics is None:
            raise ValueError("store has no MetricSet; use push(config, y)")
        return self.push_vector_encoded(
            self.space.encode(config), self.metrics.signed_vector(values), key=key
        )

    def push_vector_encoded(
        self, x: np.ndarray, yvec: np.ndarray, key: Optional[Hashable] = None
    ) -> bool:
        """Append one encoded row with its full signed metric vector (M,)."""
        yvec = np.asarray(yvec, dtype=np.float64).reshape(-1)
        if yvec.shape[0] != self.num_metrics:
            raise ValueError(
                f"expected {self.num_metrics} metric values, got {yvec.shape[0]}"
            )
        if self.num_metrics == 1:
            return self.push_encoded(x, float(yvec[0]), key=key)
        if not np.all(np.isfinite(yvec)):
            return False
        n = self.num_observations
        if n >= self._x.shape[0]:
            self._grow(bucket_size(n + 1))
        self._x[n] = x
        self._y[n] = yvec[0]
        self._yx[n] = yvec[1:]
        self._n_own += 1
        self._own_keys.append(key)
        self._own_costs.append(None)
        return True

    def rewrite_own_y(self, own_index: int, y: float) -> None:
        """Objective-value correction of an own row (x unchanged). No GP
        factor update is needed: the factorization depends only on X, and
        targets re-standardize + alpha-refresh on every decision anyway."""
        y = float(y)
        if not math.isfinite(y):
            raise ValueError("corrected objective must be finite")
        if not 0 <= own_index < self._n_own:
            raise IndexError(f"own row {own_index} out of range [0, {self._n_own})")
        self._y[self._num_parents + own_index] = y

    def delete_own(self, own_index: int) -> np.ndarray:
        """Remove this job's own row ``own_index`` (0-based among own rows) —
        an explicit history correction. The suffix shifts up so live rows
        stay a prefix; returns the encoded x of the removed row (what the GP
        layer needs to mirror the deletion with a rank-1 downdate)."""
        if not 0 <= own_index < self._n_own:
            raise IndexError(f"own row {own_index} out of range [0, {self._n_own})")
        row = self._num_parents + own_index
        n = self.num_observations
        removed = self._x[row].copy()
        self._x[row : n - 1] = self._x[row + 1 : n]
        self._y[row : n - 1] = self._y[row + 1 : n]
        self._yx[row : n - 1] = self._yx[row + 1 : n]
        self._x[n - 1] = 0.0
        self._y[n - 1] = 0.0
        self._yx[n - 1] = 0.0
        self._n_own -= 1
        del self._own_keys[own_index]
        del self._own_costs[own_index]
        return removed

    def _grow(self, cap: int) -> None:
        d = self._x.shape[1]
        x = np.zeros((cap, d), dtype=np.float64)
        y = np.zeros((cap,), dtype=np.float64)
        yx = np.zeros((cap, self._yx.shape[1]), dtype=np.float64)
        n = self.num_observations
        x[:n], y[:n], yx[:n] = self._x[:n], self._y[:n], self._yx[:n]
        self._x, self._y, self._yx = x, y, yx

    def mark_pending(self, key: Hashable, config: Mapping[str, Any]) -> None:
        self._pending[key] = (dict(config), self.space.encode(config))

    def clear_pending(self, key: Hashable) -> None:
        self._pending.pop(key, None)

    # --------------------------------------------------------------- views
    def own_keys(self) -> List[Optional[Hashable]]:
        """Per-own-row caller keys (trial ids), in push order — the handle
        the multi-fidelity layer joins store rows to rung tables with. None
        entries are rows pushed by key-less callers."""
        return list(self._own_keys)

    def own_costs(self) -> List[Optional[float]]:
        """Per-own-row simulated trial costs, in push order (None entries are
        rows pushed by cost-less callers) — what the cost head standardizes
        over. Parent rows never carry costs (a sibling's spend is not this
        job's)."""
        return list(self._own_costs)

    @property
    def has_costs(self) -> bool:
        """True iff any own row carries a recorded cost. Gates every
        serialized ``own_costs`` key so cost-off state stays byte-identical
        to the pre-cost schema."""
        return any(c is not None for c in self._own_costs)

    def x_rows(self, start: int, stop: int) -> np.ndarray:
        """Encoded rows [start, stop) — the append log a cached posterior
        reads to catch up via rank-1 updates."""
        return self._x[start:stop]

    def pending_encoded(self) -> np.ndarray:
        if not self._pending:
            return np.zeros((0, self.space.encoded_dim))
        return np.stack([x for _, x in self._pending.values()], axis=0)

    def pending_configs(self) -> List[Dict[str, Any]]:
        return [dict(c) for c, _ in self._pending.values()]

    # ------------------------------------------------------ standardization
    def _own_moments(self) -> Tuple[float, float]:
        # two-pass moments: the one-pass sumsq/n − mean² form cancels
        # catastrophically for large-mean objectives (e.g. 1e9 ± 1e-3),
        # which would squash own z-scores to noise next to parent rows.
        own = self._y[self._num_parents : self.num_observations]
        if len(own) == 0:
            return 0.0, 1.0
        mean = float(own.mean())
        std = float(own.std())
        return mean, std if std > _STD_FLOOR else 1.0

    def combined_y(self) -> np.ndarray:
        """Parent z-scores followed by own objectives (own z-scored against
        each other iff parents are present and ≥ 2 own rows exist — the
        per-task alignment of paper §5.3)."""
        n, npar = self.num_observations, self._num_parents
        y = self._y[:n].copy()
        if npar > 0 and self._n_own >= 2:
            mean, std = self._own_moments()
            y[npar:] = (y[npar:] - mean) / std
        return y

    def standardized(self) -> Tuple[np.ndarray, np.ndarray, float, float]:
        """(X_view, y_std, mean, scale): the zero-mean/unit-std targets the GP
        consumes, plus the affine used (to map predictions back if needed).
        X_view is a read-only prefix view — copy before mutating."""
        n = self.num_observations
        y = self.combined_y()
        if n == 0:
            return self._x[:0], y, 0.0, 1.0
        mean = float(y.mean())
        std = float(y.std())
        scale = std if std > _STD_FLOOR else 1.0
        return self._x[:n], (y - mean) / scale, mean, scale

    def metric_matrix(self) -> np.ndarray:
        """Signed (minimize-convention) raw metric values of the own rows:
        (n_own, M). Column 0 is the objective. Copy, safe to mutate."""
        npar, n = self._num_parents, self.num_observations
        out = np.empty((self._n_own, self.num_metrics), dtype=np.float64)
        out[:, 0] = self._y[npar:n]
        if self.num_metrics > 1:
            out[:, 1:] = self._yx[npar:n]
        return out

    def standardized_metrics(
        self,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(X_view, Y_std, means, scales) for the multi-metric engine:
        Y_std is (n, M) with every column independently z-scored over the
        own rows. Column 0 is numerically identical to ``standardized()``'s
        vector (multi-metric stores hold no parent rows, so the combined
        standardization degenerates to the own-row z-score)."""
        n = self.num_observations
        m = self.num_metrics
        means = np.zeros(m)
        scales = np.ones(m)
        x_view, y0, means[0], scales[0] = self.standardized()
        ystd = np.empty((n, m), dtype=np.float64)
        ystd[:, 0] = y0
        for j in range(1, m):
            col = np.ascontiguousarray(self._yx[self._num_parents : n, j - 1])
            if len(col):
                mean = float(col.mean())
                std = float(col.std())
                scale = std if std > _STD_FLOOR else 1.0
            else:
                mean, scale = 0.0, 1.0
            means[j], scales[j] = mean, scale
            ystd[:, j] = (col - mean) / scale
        return x_view, ystd, means, scales

    # -------------------------------------------------------------- export
    def history_pairs(self) -> List[Observation]:
        """Decoded (config, objective) pairs in the seed suggester-history
        convention — the compatibility feed for stateless suggesters."""
        n = self.num_observations
        y = self.combined_y()
        return [
            (self.space.decode(self._x[i]), float(y[i])) for i in range(n)
        ]

    def own_pairs(self) -> List[Observation]:
        """This job's *own* finished observations as decoded (config, raw
        objective) pairs — parent rows excluded, objectives unscaled. This is
        the export a ``SelectionService`` feeds to a sibling job's
        ``WarmStartPool`` (which re-applies the per-task z-scoring itself)."""
        npar, n = self._num_parents, self.num_observations
        return [
            (self.space.decode(self._x[i]), float(self._y[i]))
            for i in range(npar, n)
        ]

    def nbytes(self) -> int:
        """Resident bytes of the store: the row buffers (X, y, extra metric
        columns — at *capacity*, since the capacity-doubled arrays are what
        actually sit in memory) plus the encoded pending buffers. This is the
        un-evictable floor the ``FactorArena`` end-to-end budget counts
        alongside the factor blocks."""
        total = int(self._x.nbytes + self._y.nbytes + self._yx.nbytes)
        for _, x in self._pending.values():
            total += int(x.nbytes)
        return total

    def fingerprint(self) -> str:
        """Content hash of the live rows (parents + own, byte-exact) plus
        the parent/pending counts. Two stores with equal fingerprints hold
        bitwise-identical observation data — the check a re-adopting client
        runs against a replica's resident store before trusting it (see
        ``repro_torch.core.rpc.RegisterReply.store_fingerprint``)."""
        from repro_torch.core.gp.serialize import array_fingerprint

        n = self.num_observations
        fp = (
            f"{self._num_parents}:{self.num_pending}:"
            f"{array_fingerprint(self._x[:n])}:{array_fingerprint(self._y[:n])}"
        )
        if self.num_metrics > 1:
            fp += f":{array_fingerprint(self._yx[:n])}"
        if self.has_costs:
            fp += ":" + array_fingerprint(np.asarray(
                [math.nan if c is None else c for c in self._own_costs],
                dtype=np.float64,
            ))
        return fp

    # ---------------------------------------------------------- persistence
    def state_dict(self) -> Dict[str, Any]:
        """Own rows only: parents are reconstructed from the warm-start pool
        (which checkpoints separately), pending from the trial table."""
        npar, n = self._num_parents, self.num_observations
        state = {
            "own_x": self._x[npar:n].tolist(),
            "own_y": self._y[npar:n].tolist(),
            "own_keys": list(self._own_keys),
        }
        if self.num_metrics > 1:
            state["own_yx"] = self._yx[npar:n].tolist()
        if self.has_costs:
            state["own_costs"] = list(self._own_costs)
        return state

    def snapshot(self) -> Dict[str, Any]:
        """Complete, self-contained wire image of the store: parent rows
        (already encoded + per-task z-scored), own rows, and the pending set.

        Unlike ``state_dict`` (the Tuner checkpoint blob, which leans on the
        warm-start pool and trial table to rebuild parents/pending), a
        snapshot must let a *fresh process with nothing but the bytes*
        reproduce the store exactly — that is the contract the cross-process
        engine replicas (``repro.distributed``) rely on for bit-equivalent
        suggestions. Arrays travel as exact base64 byte images
        (``repro_torch.core.gp.serialize``); pending keys must be JSON-safe
        scalars (the Tuner uses integer trial ids).
        """
        from repro_torch.core.gp.serialize import array_to_wire

        npar, n = self._num_parents, self.num_observations
        snap = {
            "parent_x": array_to_wire(self._x[:npar]),
            "parent_y": array_to_wire(self._y[:npar]),
            "own_x": array_to_wire(self._x[npar:n]),
            "own_y": array_to_wire(self._y[npar:n]),
            "own_keys": list(self._own_keys),
            "pending": [
                [key, dict(cfg), array_to_wire(x)]
                for key, (cfg, x) in self._pending.items()
            ],
        }
        if self.num_metrics > 1:
            snap["own_yx"] = array_to_wire(self._yx[npar:n])
        if self.has_costs:
            snap["own_costs"] = list(self._own_costs)
        return snap

    def load_snapshot(self, snap: Mapping[str, Any]) -> None:
        """Replace the store's entire contents with ``snapshot()`` output —
        parent rows, own rows (in push order), and the pending set."""
        from repro_torch.core.gp.serialize import array_from_wire

        px = array_from_wire(snap["parent_x"])
        pz = array_from_wire(snap["parent_y"])
        d = self.space.encoded_dim
        m_extra = self.num_metrics - 1
        self._num_parents = int(px.shape[0])
        cap = bucket_size(max(8, self._num_parents))
        self._x = np.zeros((cap, d), dtype=np.float64)
        self._y = np.zeros((cap,), dtype=np.float64)
        self._yx = np.zeros((cap, m_extra), dtype=np.float64)
        self._x[: self._num_parents] = px.reshape(-1, d)
        self._y[: self._num_parents] = pz
        self._n_own = 0
        self._own_keys = []
        self._own_costs = []
        self._pending = {}
        own_x = array_from_wire(snap["own_x"]).reshape(-1, d)
        own_y = array_from_wire(snap["own_y"])
        keys = snap.get("own_keys") or [None] * len(own_x)
        costs = snap.get("own_costs") or [None] * len(own_x)
        if m_extra > 0:
            own_yx = array_from_wire(snap["own_yx"]).reshape(-1, m_extra)
            for x, y, yx, k in zip(own_x, own_y, own_yx, keys):
                self.push_vector_encoded(x, np.concatenate(([y], yx)), key=k)
        else:
            for x, y, k, c in zip(own_x, own_y, keys, costs):
                self.push_encoded(x, float(y), key=k, cost=c)
        for key, cfg, x in snap["pending"]:
            self._pending[key] = (dict(cfg), array_from_wire(x))

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        self._n_own = 0
        self._own_keys = []
        self._own_costs = []
        self._pending.clear()
        keys = state.get("own_keys") or [None] * len(state["own_x"])
        costs = state.get("own_costs") or [None] * len(state["own_x"])
        if self.num_metrics > 1:
            for x, y, yx, k in zip(
                state["own_x"], state["own_y"], state["own_yx"], keys
            ):
                self.push_vector_encoded(
                    np.asarray(x, dtype=np.float64),
                    np.concatenate(([float(y)], np.asarray(yx, dtype=np.float64))),
                    key=k,
                )
            return
        for x, y, k, c in zip(state["own_x"], state["own_y"], keys, costs):
            self.push_encoded(np.asarray(x, dtype=np.float64), float(y),
                              key=k, cost=c)
