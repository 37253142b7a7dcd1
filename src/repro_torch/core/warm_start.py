"""Warm start from parent tuning jobs (paper §5.3).

"We thus opted for a light-weight solution, purely based on past
hyperparameter evaluations and requiring no access to meta-data."

Mechanism: each parent job contributes its (config, objective) history. When a
child job starts, parent observations are

  1. re-encoded through the *child's* search space — the paper's §6.2 lesson
     is handled here: a parent value that is invalid under the child space
     (e.g. 0 under a log-scaled HP, or out of the child's bounds) is dropped,
     never silently clipped into validity;
  2. standardized *per task* (z-scored within each parent job), which aligns
     objective scales across jobs/datasets without any meta-data; and
  3. concatenated into the GP dataset. Transfer happens through the shared
     surrogate: with stationary tasks this biases the search toward the
     parents' good regions immediately (Fig. 5 behaviour).

The per-task z-scoring is a deliberately simple instance of the quantile-based
transfer family (Salinas et al., 2020 — the paper's ref [49]).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np

from repro_torch.core.search_space import Categorical, Continuous, Integer, SearchSpace

__all__ = ["WarmStartPool", "transferable"]

Observation = Tuple[Mapping[str, Any], float]


def transferable(child_space: SearchSpace, config: Mapping[str, Any]) -> bool:
    """True iff ``config`` is a valid point of ``child_space``.

    Validity per HP type:
      * Continuous/Integer: value within [low, high]; under log scaling the
        value must additionally be > 0 (the paper's §6.2 edge case).
      * Categorical: value must be one of the child's choices.
    Missing HPs make the config non-transferable (we do not impute).
    """
    for p in child_space.parameters:
        if p.name not in config:
            return False
        v = config[p.name]
        if isinstance(p, Categorical):
            if v not in p.choices:
                return False
        else:
            try:
                fv = float(v)
            except (TypeError, ValueError):
                return False
            if math.isnan(fv) or fv < p.low or fv > p.high:
                return False
            if p.scaling == "log" and fv <= 0:
                return False
    return True


@dataclasses.dataclass
class _ParentJob:
    name: str
    history: List[Observation]


class WarmStartPool:
    """Collects parent tuning-job histories and exports them against a child
    search space."""

    def __init__(self) -> None:
        self._parents: List[_ParentJob] = []

    def add_parent(self, history: Sequence[Observation], name: str = "") -> None:
        obs = [(dict(c), float(y)) for c, y in history if np.isfinite(y)]
        self._parents.append(_ParentJob(name or f"parent{len(self._parents)}", obs))

    @property
    def num_parents(self) -> int:
        return len(self._parents)

    @property
    def parent_names(self) -> List[str]:
        return [p.name for p in self._parents]

    @classmethod
    def merged(cls, *pools: "WarmStartPool") -> "WarmStartPool":
        """Union of pools, preserving per-parent task identity (the per-task
        z-scoring is what makes pooling jobs with different objective scales
        sound — paper §5.3). A ``SelectionService`` uses this to combine a
        user-supplied pool with live sibling-job histories."""
        out = cls()
        for pool in pools:
            if pool is None:
                continue
            for p in pool._parents:
                out.add_parent(p.history, name=p.name)
        return out

    def export(
        self, child_space: SearchSpace
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Return (X_unit, y_std, task_id, num_dropped) over all parents.

        X_unit: (m, D) encoded through the child space; y_std: per-task
        z-scored objectives; task_id: integer provenance per row.
        """
        xs: List[np.ndarray] = []
        ys: List[float] = []
        tids: List[int] = []
        dropped = 0
        for tid, parent in enumerate(self._parents):
            valid = [
                (c, y) for c, y in parent.history if transferable(child_space, c)
            ]
            dropped += len(parent.history) - len(valid)
            if len(valid) < 2:
                dropped += len(valid)
                continue  # can't standardize a single point meaningfully
            yv = np.asarray([y for _, y in valid], dtype=np.float64)
            std = yv.std()
            yz = (yv - yv.mean()) / (std if std > 1e-12 else 1.0)
            for (c, _), z in zip(valid, yz):
                xs.append(child_space.encode(c))
                ys.append(float(z))
                tids.append(tid)
        if not xs:
            d = child_space.encoded_dim
            return np.zeros((0, d)), np.zeros((0,)), np.zeros((0,), np.int64), dropped
        return (
            np.stack(xs, axis=0),
            np.asarray(ys, dtype=np.float64),
            np.asarray(tids, dtype=np.int64),
            dropped,
        )

    def as_observations(
        self, child_space: SearchSpace
    ) -> List[Observation]:
        """Parent data as (config, z-scored objective) pairs in the child
        space — directly prependable to a suggester's history."""
        x, y, _, _ = self.export(child_space)
        return [(child_space.decode(xi), float(yi)) for xi, yi in zip(x, y)]

    # ----------------------------------------------------------- persistence
    def state_dict(self) -> Dict:
        return {
            "parents": [
                {"name": p.name, "history": [[dict(c), y] for c, y in p.history]}
                for p in self._parents
            ]
        }

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        self._parents = [
            _ParentJob(p["name"], [(dict(c), float(y)) for c, y in p["history"]])
            for p in state["parents"]
        ]
