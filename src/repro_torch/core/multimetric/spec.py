"""Named-metric declarations for multi-metric tuning jobs.

The paper frames AMT as optimizing "the metric chosen by the user" (§3);
real tuning jobs usually watch several. A job declares its metrics once as an
ordered tuple of ``MetricSpec``s — the first is always the (primary)
objective — and every trial then reports a named metric dict
(``{"val_loss": ..., "latency_ms": ...}``). Three modes fall out of the
declaration, detected by ``MetricSet.mode``:

  * ``single``      — one objective, no constraints: exactly today's engine
    (the M=1 path is bit-identical to a job with no metric declaration);
  * ``constrained`` — one objective plus thresholded constraint metrics:
    the engine maximizes EI × Π P(feasible) (Gardner et al. 2014 style) and
    the tuner reports the best *feasible* trial;
  * ``pareto``      — ≥ 2 objectives (constraints still allowed): the engine
    optimizes random-scalarization EI over simplex weight draws (ParEGO
    style) and the tuner tracks the non-dominated front.

Sign convention: the decision engine minimizes. ``MetricSet.signed_vector``
maps a raw metric dict to the internal minimize-convention vector (maximize
metrics are negated, thresholds too), so everything downstream of the
``ObservationStore`` is direction-free.

Ordering contract (validated): objectives come first, constraints after.
The fused multi-head scorer and the scalarization math slice objective
heads as a leading block, so the order is part of the engine contract, not
a style preference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = ["MetricSpec", "MetricSet"]


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One named metric of a tuning job.

    Args:
        name: key of this metric in the trial's reported metric dict.
        goal: ``"minimize"`` (default) or ``"maximize"``.
        objective: True if this metric is optimized (the Pareto/EI target);
            False makes it a constraint, which then requires ``threshold``.
        threshold: constraint bound in *raw* metric units — feasible means
            ``value <= threshold`` under ``goal="minimize"`` and
            ``value >= threshold`` under ``goal="maximize"``. Must be None
            for objectives (the engine optimizes them, it does not gate).
    """

    name: str
    goal: str = "minimize"
    objective: bool = True
    threshold: Optional[float] = None

    def __post_init__(self):
        if self.goal not in ("minimize", "maximize"):
            raise ValueError(f"{self.name}: goal must be minimize|maximize")
        if self.objective and self.threshold is not None:
            raise ValueError(
                f"{self.name}: an objective metric cannot carry a threshold "
                "(declare a second, non-objective spec to constrain it)"
            )
        if not self.objective and self.threshold is None:
            raise ValueError(
                f"{self.name}: a constraint metric needs a threshold"
            )
        if not self.name:
            raise ValueError("metric name must be non-empty")

    @property
    def sign(self) -> float:
        """+1 for minimize, −1 for maximize (the engine minimizes)."""
        return 1.0 if self.goal == "minimize" else -1.0

    # ------------------------------------------------------------ wire image
    def to_wire(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "goal": self.goal,
            "objective": self.objective,
            "threshold": self.threshold,
        }

    @staticmethod
    def from_wire(blob: Mapping[str, Any]) -> "MetricSpec":
        return MetricSpec(
            name=blob["name"],
            goal=blob.get("goal", "minimize"),
            objective=bool(blob.get("objective", True)),
            threshold=None
            if blob.get("threshold") is None
            else float(blob["threshold"]),
        )


class MetricSet:
    """An ordered, validated collection of a job's ``MetricSpec``s.

    Invariants (enforced at construction):
      * at least one metric, unique names;
      * the first metric is an objective (column 0 of the observation
        store's Y block is the primary objective — the M=1 degenerate case
        must coincide with the single-metric engine exactly);
      * objectives precede constraints (the multi-head scorers slice
        objective heads as a leading block).
    """

    def __init__(self, specs: Sequence[MetricSpec]):
        specs = tuple(specs)
        if not specs:
            raise ValueError("MetricSet needs at least one MetricSpec")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate metric names: {names}")
        if not specs[0].objective:
            raise ValueError(
                "the first metric must be an objective (it is column 0 of "
                "the engine's Y block)"
            )
        seen_constraint = False
        for s in specs:
            if not s.objective:
                seen_constraint = True
            elif seen_constraint:
                raise ValueError(
                    "objectives must precede constraints in the metric list"
                )
        self.specs: Tuple[MetricSpec, ...] = specs

    # -------------------------------------------------------------- counters
    @property
    def num_metrics(self) -> int:
        return len(self.specs)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.specs)

    @property
    def num_objectives(self) -> int:
        return sum(1 for s in self.specs if s.objective)

    @property
    def num_constraints(self) -> int:
        return len(self.specs) - self.num_objectives

    @property
    def constraint_specs(self) -> Tuple[MetricSpec, ...]:
        return tuple(s for s in self.specs if not s.objective)

    @property
    def mode(self) -> str:
        """``"single"`` | ``"constrained"`` | ``"pareto"``."""
        if self.num_objectives >= 2:
            return "pareto"
        return "constrained" if self.num_constraints else "single"

    # ------------------------------------------------------------ conversion
    def signed_vector(self, values: Mapping[str, float]) -> np.ndarray:
        """Raw metric dict → internal minimize-convention vector (M,).

        Raises ``KeyError`` on a missing metric. Non-finite values are the
        caller's problem (the store drops such rows, like today)."""
        out = np.empty(len(self.specs), dtype=np.float64)
        for i, s in enumerate(self.specs):
            out[i] = s.sign * float(values[s.name])
        return out

    def signed_thresholds(self) -> np.ndarray:
        """Constraint bounds in the signed (minimize) convention, ordered as
        the trailing constraint block: feasible ⇔ signed value ≤ entry."""
        return np.asarray(
            [s.sign * s.threshold for s in self.specs if not s.objective],
            dtype=np.float64,
        )

    def feasible(self, values: Mapping[str, float]) -> bool:
        """Does a raw metric dict satisfy every declared constraint? A
        missing or non-finite constraint metric is *infeasible* — a
        constraint that cannot be verified is not satisfied."""
        for s in self.specs:
            if s.objective:
                continue
            if s.name not in values:
                return False
            v = s.sign * float(values[s.name])
            if not (math.isfinite(v) and v <= s.sign * s.threshold):
                return False
        return True

    # ------------------------------------------------------------ wire image
    def to_wire(self) -> List[Dict[str, Any]]:
        return [s.to_wire() for s in self.specs]

    @staticmethod
    def from_wire(blobs: Optional[Sequence[Mapping[str, Any]]]) -> Optional["MetricSet"]:
        if blobs is None:
            return None
        return MetricSet([MetricSpec.from_wire(b) for b in blobs])

    def __repr__(self) -> str:
        parts = []
        for s in self.specs:
            tag = "obj" if s.objective else f"≤{s.threshold}"
            parts.append(f"{s.name}:{s.goal[:3]}:{tag}")
        return f"MetricSet({self.mode}; " + ", ".join(parts) + ")"
