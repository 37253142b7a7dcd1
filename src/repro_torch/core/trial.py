"""Trial state machine (paper §3.2: each candidate HP set is a training job).

States mirror SageMaker training-job semantics:

    PENDING ──▶ RUNNING ──▶ COMPLETED                (ran to the end)
                   │  ├───▶ STOPPED                  (early-stopped; still
                   │  │                               yields an objective)
                   │  └───▶ FAILED ──▶ PENDING(retry) (paper §3.3: built-in
                   │                                   retry mechanism)
                   └──────▶ FAILED                   (retries exhausted)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

__all__ = ["Trial", "TrialState"]


class TrialState:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    STOPPED = "STOPPED"  # early-stopped by the median rule / ASHA / timeout
    FAILED = "FAILED"

    TERMINAL = (COMPLETED, STOPPED, FAILED)


@dataclasses.dataclass
class Trial:
    trial_id: int
    config: Dict[str, Any]
    state: str = TrialState.PENDING
    curve: List[float] = dataclasses.field(default_factory=list)
    final_objective: Optional[float] = None
    submit_time: float = 0.0
    start_time: Optional[float] = None
    end_time: Optional[float] = None
    attempts: int = 0
    error: Optional[str] = None
    stopped_early: bool = False
    resource_used: int = 0  # training iterations actually executed
    # named metric dict reported at completion (multi-metric jobs; raw
    # per-goal values, unsigned — see repro_torch.core.multimetric.MetricSet)
    metrics: Optional[Dict[str, float]] = None
    # authoritative signed objective resolved from the metric dict. When the
    # tuner sets it, ``objective`` returns it verbatim — the curve stream
    # must not be consulted (for maximize goals the raw curve values have
    # the wrong sign, and min() over them would corrupt ranking/seeding).
    objective_from_metrics: Optional[float] = None

    # ------------------------------------------------------------- helpers
    @property
    def is_terminal(self) -> bool:
        return self.state in TrialState.TERMINAL

    @property
    def objective(self) -> float:
        """Best observed objective (min over the curve / final), or +inf.

        A COMPLETED trial *must* carry a finite final value: it ran to the
        end, so a NaN/inf terminal metric means the objective itself is
        invalid (diverged loss, broken eval) and the curve minimum is not a
        substitute — such a trial must neither seed the GP nor win the job.
        The curve fallback is reserved for early-STOPPED trials, where the
        best-so-far curve value is the intended objective.

        ``objective_from_metrics`` (set by the tuner when a declared metric
        dict resolves the objective authoritatively) short-circuits all of
        the above.
        """
        if self.objective_from_metrics is not None:
            return self.objective_from_metrics
        if self.state == TrialState.COMPLETED and (
            self.final_objective is None
            or not math.isfinite(self.final_objective)
        ):
            return float("inf")
        cands = []
        if self.final_objective is not None and math.isfinite(self.final_objective):
            cands.append(self.final_objective)
        cands.extend(v for v in self.curve if math.isfinite(v))
        return min(cands) if cands else float("inf")

    @property
    def duration(self) -> float:
        if self.start_time is None or self.end_time is None:
            return 0.0
        return self.end_time - self.start_time

    # --------------------------------------------------------- persistence
    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Trial":
        return Trial(**d)
