"""Budget accounting for cost-aware tuning (paper §3: AMT bills by time).

One ``BudgetLedger`` per job tracks simulated spend against
``TuningJobConfig.max_cost``. Two invariants:

* **Clock discipline** — the ledger never reads a clock. Charges are
  computed by the Tuner from *backend event times* (``TrialEvent.time``,
  i.e. the discrete-event clock of ``SimBackend``/``TabulatedBackend``),
  so replayed runs observe identical spend.
* **Bounded overspend** — budgets gate *new* launches only; trials already
  in flight run to completion. The ledger can therefore overspend
  ``max_cost`` by at most the cost of the trials that were in flight when
  it crossed the line (one per free slot), never by work launched after.

The ledger's state is two floats; it rides ``BOSuggester.state_dict()``
under the ``"budget"`` key (absent when budgets are off), which puts it in
Tuner checkpoints with no new channel, in the JAX package's schema.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

__all__ = ["BudgetExhaustedError", "BudgetLedger"]


class BudgetExhaustedError(RuntimeError):
    """A decision was requested after the job's budget ran out.

    Typed so callers can distinguish "stop cleanly, budget spent" from
    engine failure.
    """

    def __init__(self, message: str, *, spent: float = 0.0,
                 max_cost: Optional[float] = None):
        super().__init__(message)
        self.spent = spent
        self.max_cost = max_cost


class BudgetLedger:
    """Monotone spend counter against an optional cap.

    Args:
        max_cost: total simulated cost the job may consume (None = no cap;
            the ledger still tracks spend for cost-cooling and reporting).
    """

    def __init__(self, max_cost: Optional[float] = None):
        self.max_cost = None if max_cost is None else float(max_cost)
        self.spent = 0.0

    # ------------------------------------------------------------- charging
    def charge(self, cost: float) -> float:
        """Add one trial's cost (from backend event times — never a wall
        clock) and return the new total. Non-finite or negative charges are
        ignored rather than corrupting the ledger."""
        c = float(cost)
        if math.isfinite(c) and c > 0.0:
            self.spent += c
        return self.spent

    @property
    def exhausted(self) -> bool:
        return self.max_cost is not None and self.spent >= self.max_cost

    @property
    def remaining(self) -> float:
        if self.max_cost is None:
            return math.inf
        return max(0.0, self.max_cost - self.spent)

    def check(self, job_name: str = "") -> None:
        """Raise the typed refusal if the budget is spent."""
        if self.exhausted:
            raise BudgetExhaustedError(
                f"job {job_name!r}: budget exhausted "
                f"({self.spent:.6g} of max_cost {self.max_cost:.6g} spent)",
                spent=self.spent, max_cost=self.max_cost,
            )

    # ------------------------------------------------------------ state i/o
    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe image; rides checkpoints."""
        return {"max_cost": self.max_cost, "spent": self.spent}

    def load_snapshot(self, snap: Mapping[str, Any]) -> None:
        mc = snap.get("max_cost")
        self.max_cost = None if mc is None else float(mc)
        self.spent = float(snap.get("spent", 0.0))

    def __repr__(self) -> str:  # debugging aid only
        return (f"BudgetLedger(spent={self.spent:.6g}, "
                f"max_cost={self.max_cost})")
