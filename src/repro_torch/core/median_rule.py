"""Automated early stopping via the median rule (paper §5.2).

"AMT employs the simple but effective median rule [Golovin et al., Vizier] to
determine which HP configurations to stop early. If f(x_t^r) is worse than the
median of the previously evaluated configurations at the same iteration r, we
stop the training."

Resilience details implemented exactly as described:
  * decisions are only made after a minimum number of training iterations;
    this threshold is *dynamic*: a fraction of the median length of fully
    completed evaluations (the paper: "determined dynamically based on the
    duration of the fully completed hyperparameter evaluations");
  * comparisons use the running best (cummin) of each curve, so noisy
    intermediate metrics don't trigger spurious stops;
  * (the paper evaluated "always complete 10 evaluations first" and discarded
    it; we expose ``min_completed_curves`` with a small default instead).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["MedianRule", "MedianRuleConfig"]


@dataclasses.dataclass(frozen=True)
class MedianRuleConfig:
    min_completed_curves: int = 3  # curves needed before the rule activates
    min_iteration_fraction: float = 0.25  # dynamic threshold (× median length)
    min_iteration_floor: int = 1  # never stop before this many iterations


class MedianRule:
    """Tracks learning curves f(x, r) and answers should_stop queries.

    Minimization convention: curves are sequences of objective values per
    training iteration r = 1, 2, ...; lower is better.
    """

    def __init__(self, config: MedianRuleConfig = MedianRuleConfig()):
        self.config = config
        # trial key -> cummin curve. Keying by trial id makes recording
        # *idempotent*: a restored job that replays a completion (or a caller
        # that reports the same trial twice) overwrites instead of
        # double-counting the curve in the median. Anonymous callers
        # (``trial_id=None``) get a fresh key per call.
        self._completed: Dict = {}
        self._anon = 0

    # ----------------------------------------------------------------- state
    def record_completed(
        self, curve: Sequence[float], trial_id: Optional[int] = None
    ) -> None:
        """Register the full learning curve of a trial that ran to the end."""
        c = np.asarray(list(curve), dtype=np.float64)
        if not c.size:
            return
        if trial_id is None:
            self._anon += 1
            key = f"anon-{self._anon}"
        else:
            key = trial_id
        self._completed[key] = np.minimum.accumulate(c)

    @property
    def num_completed(self) -> int:
        return len(self._completed)

    def activation_iteration(self) -> int:
        """Dynamic minimum iteration before any stopping decision."""
        if not self._completed:
            return np.iinfo(np.int32).max
        med_len = float(np.median([len(c) for c in self._completed.values()]))
        dyn = int(np.ceil(self.config.min_iteration_fraction * med_len))
        return max(self.config.min_iteration_floor, dyn)

    # ------------------------------------------------------------- decision
    def should_stop(
        self, curve: Sequence[float], trial_id: Optional[int] = None
    ) -> bool:
        """Decide for a *running* trial given its metric history so far."""
        cfg = self.config
        if len(self._completed) < cfg.min_completed_curves:
            return False
        c = np.asarray(list(curve), dtype=np.float64)
        r = c.size
        if r < self.activation_iteration():
            return False
        best_so_far = float(np.min(c))
        # median of completed curves' running best at the same iteration r
        peers = [
            pc[min(r, len(pc)) - 1]
            for pc in self._completed.values()
            if len(pc) > 0
        ]
        if not peers:
            return False
        return best_so_far > float(np.median(peers))

    # ----------------------------------------------------------- persistence
    def state_dict(self) -> Dict:
        return {
            "completed": [
                [key, c.tolist()] for key, c in self._completed.items()
            ],
            "anon": self._anon,
        }

    def load_state_dict(self, state: Dict) -> None:
        self._completed = {}
        for i, e in enumerate(state["completed"]):
            if (
                isinstance(e, (list, tuple))
                and len(e) == 2
                and isinstance(e[1], (list, tuple))
            ):
                key, c = e
            else:  # legacy unkeyed format: plain curves
                key, c = f"legacy-{i}", e
            self._completed[key] = np.asarray(c, dtype=np.float64)
        self._anon = int(state.get("anon", 0))
