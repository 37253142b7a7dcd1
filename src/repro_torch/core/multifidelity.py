"""In-service ASHA promotion state (multi-fidelity engine, ROADMAP item 1).

The paper's automated early stopping (§5.2) lived purely in the Tuner as a
client-side stopping rule; this module moves the promote/stop decision into
the ``SelectionService`` so that (a) the rung tables feed the per-rung GP
heads of ``core/gp/per_resource`` — partial curves become the decision
signal, not a reporting detail — and (b) the decisions travel the same
snapshot/oplog machinery as suggestions, keeping every failover invariant.

Design constraints, in order:

* **Idempotent by (trial, rung).** A restored tuner replays reports for
  re-queued RUNNING trials, and a failed-over client replays its oplog
  against a fresh replica; both re-issue ``report_rung`` for crossings the
  state has already seen. Values overwrite (never re-append) and decisions
  are *memoized* — the replay gets the original decision back even though
  the rung has since gained peers.
* **Deterministic and RNG-free.** The decision is classic ASHA over the
  rung table (top-1/η quantile of recorded running-best values); no GP in
  the stop path. Replaying the same report stream against a restored
  snapshot reproduces every decision bit-exactly, which is what the
  ``MirroredStore`` failover verification checks. Curve-awareness enters
  through *acquisition* (the per-rung heads), where determinism is already
  guaranteed by the RNG-free factor-rebuild invariants.
* **Minimize convention.** Values arriving here are already signed into
  the engine's minimize convention by the Tuner (maximize goals flip),
  exactly like the resolved-metric pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.asha import ASHAConfig, rung_iters

__all__ = ["MultiFidelityState"]


class MultiFidelityState:
    """Rung tables + memoized promote/stop decisions for one job."""

    def __init__(self, config: ASHAConfig):
        self.config = config
        self.rung_grid: List[int] = rung_iters(config)
        # rung index -> {trial key: signed running-best value at that rung}
        self.rungs: Dict[int, Dict] = {}
        # "key@rung" -> "stop" | "continue" (memoized; replay-stable)
        self.decisions: Dict[str, str] = {}

    # ------------------------------------------------------------ decisions
    def report_rung(self, key, iteration: int, value: float) -> Tuple[str, int]:
        """Record a trial's rung crossing and decide promote/stop.

        Returns ``(decision, rung_index)``; a non-rung iteration is a no-op
        ``("continue", -1)``. Below the ``eta`` evidence threshold every
        trial is promoted (the value is still recorded — keyed, so a later
        replay cannot double-count it).
        """
        iteration = int(iteration)
        if iteration not in self.rung_grid:
            return "continue", -1
        k = self.rung_grid.index(iteration)
        value = float(value)
        dkey = f"{key}@{k}"
        table = self.rungs.setdefault(k, {})
        table[key] = value  # idempotent: overwrite, never re-append
        prior = self.decisions.get(dkey)
        if prior is not None:
            return prior, k
        if len(table) < self.config.eta:
            decision = "continue"
        else:
            cutoff = float(
                np.quantile(list(table.values()), 1.0 / self.config.eta)
            )
            decision = "stop" if value > cutoff else "continue"
        self.decisions[dkey] = decision
        return decision, k

    def value_at(self, key, k: int) -> Optional[float]:
        v = self.rungs.get(k, {}).get(key)
        return None if v is None else float(v)

    def num_active_rungs(self) -> int:
        """1 + the highest rung index holding any recorded value (0 if the
        tables are empty) — how many rung heads the engine builds."""
        occupied = [k for k, t in self.rungs.items() if t]
        return 0 if not occupied else 1 + max(occupied)

    # ------------------------------------------------------------ wire image
    def promotion(self) -> Dict:
        """Read-only JSON-safe view of the rung tables + decisions (the
        ``promotion`` RPC verb; also what the equality tests compare)."""
        return {
            "rung_grid": list(self.rung_grid),
            "rungs": {
                str(k): [[key, v] for key, v in table.items()]
                for k, table in self.rungs.items()
            },
            "decisions": dict(self.decisions),
        }

    def snapshot(self) -> Dict:
        return {"config": dataclasses.asdict(self.config), **self.promotion()}

    def load_snapshot(self, snap: Mapping) -> None:
        rungs: Dict[int, Dict] = {}
        for k, entries in snap["rungs"].items():
            rungs[int(k)] = {e[0]: float(e[1]) for e in entries}
        self.rungs = rungs
        self.decisions = dict(snap["decisions"])

    @staticmethod
    def config_from_wire(spec: Mapping) -> ASHAConfig:
        return ASHAConfig(
            r_min=int(spec["r_min"]),
            eta=int(spec["eta"]),
            max_rungs=int(spec["max_rungs"]),
        )
