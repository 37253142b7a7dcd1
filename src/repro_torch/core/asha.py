"""Asynchronous successive halving (ASHA) and synchronous SH/Hyperband.

Beyond-paper extension: the paper (§2.3) surveys successive halving, Hyperband
and ASHA as the multi-fidelity alternatives to its median rule; we implement
them as first-class *stopping/promotion policies* sharing the tuner's
early-stopping interface so they can be compared head-to-head in the
benchmarks (EXPERIMENTS.md §Perf, beyond-paper section).

ASHA (Li et al., 2019): rungs at r = r_min·η^k. A trial reaching rung k is
stopped unless its metric is in the top 1/η of *all* metrics recorded at rung
k so far (asynchronous promotion — no waiting for a full bracket).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = [
    "ASHARule",
    "ASHAConfig",
    "HyperbandConfig",
    "SynchronousHyperband",
    "rung_iters",
]


@dataclasses.dataclass(frozen=True)
class ASHAConfig:
    r_min: int = 1
    eta: int = 3
    max_rungs: int = 8


def rung_iters(config: ASHAConfig) -> List[int]:
    """The rung grid r = r_min·η^k for k < max_rungs."""
    return [config.r_min * config.eta**k for k in range(config.max_rungs)]


class ASHARule:
    """Drop-in replacement for MedianRule with ASHA semantics (minimize).

    Rung tables are keyed by trial id, so recording is *idempotent*: a trial
    whose value was folded in at rung k by a ``should_stop`` decision is not
    counted a second time when the same trial later completes (or when a
    restored job replays its reports). Callers that don't track trial ids
    (``trial_id=None``) get a fresh anonymous key per call — each anonymous
    call is treated as a distinct trial.
    """

    def __init__(self, config: ASHAConfig = ASHAConfig()):
        self.config = config
        # rung index -> {trial key: recorded cummin value at that rung}
        self._rungs: Dict[int, Dict] = {}
        self._anon = 0  # counter for anonymous (trial_id=None) callers

    def _rung_iters(self) -> List[int]:
        return rung_iters(self.config)

    def _key(self, trial_id) -> object:
        if trial_id is not None:
            return trial_id
        self._anon += 1
        return f"anon-{self._anon}"

    def record_completed(
        self, curve: Sequence[float], trial_id: Optional[int] = None
    ) -> None:
        """Completed curves also populate rungs (same interface as MedianRule).
        Idempotent per trial: rungs the trial already occupies (e.g. via an
        earlier ``should_stop`` decision) are overwritten, not re-appended."""
        c = np.minimum.accumulate(np.asarray(list(curve), dtype=np.float64))
        key = self._key(trial_id)
        for k, r in enumerate(self._rung_iters()):
            if r <= len(c):
                self._rungs.setdefault(k, {})[key] = float(c[r - 1])

    def should_stop(
        self, curve: Sequence[float], trial_id: Optional[int] = None
    ) -> bool:
        c = np.minimum.accumulate(np.asarray(list(curve), dtype=np.float64))
        r_now = len(c)
        rungs = self._rung_iters()
        # only decide exactly at rung boundaries
        if r_now not in rungs:
            return False
        k = rungs.index(r_now)
        peers = self._rungs.get(k, {})
        value = float(c[-1])
        key = self._key(trial_id)
        # evidence threshold counts this trial too; below it the rule must
        # not mutate state — the trial will be back at its next rung, and a
        # pre-recorded value here would double-count it against itself.
        if len(peers) + (0 if key in peers else 1) < self.config.eta:
            return False
        self._rungs.setdefault(k, {})[key] = value
        values = list(self._rungs[k].values())
        cutoff = float(np.quantile(values, 1.0 / self.config.eta))
        return value > cutoff

    def state_dict(self) -> Dict:
        return {
            "rungs": {
                str(k): [[key, v] for key, v in table.items()]
                for k, table in self._rungs.items()
            },
            "anon": self._anon,
        }

    def load_state_dict(self, state: Dict) -> None:
        self._rungs = {}
        for k, entries in state["rungs"].items():
            table: Dict = {}
            for i, e in enumerate(entries):
                if isinstance(e, (list, tuple)):  # [key, value] pairs
                    key, v = e
                    key = tuple(key) if isinstance(key, list) else key
                else:  # legacy unkeyed format: plain floats
                    key, v = f"legacy-{k}-{i}", e
                table[key] = float(v)
            self._rungs[int(k)] = table
        self._anon = int(state.get("anon", 0))


@dataclasses.dataclass(frozen=True)
class HyperbandConfig:
    r_max: int = 27  # max iterations a trial can use
    eta: int = 3


class SynchronousHyperband:
    """Synchronous Hyperband bracket scheduler (Li et al., 2016; paper §2.3).

    Unlike the median rule / ASHA (which are *stopping rules* attached to a
    free-running tuner), Hyperband prescribes the (n_i, r_i) ladder per
    bracket. This helper enumerates the ladder; the caller runs each rung,
    ranks, and keeps the top 1/η. Used by the early-stopping benchmark as the
    synchronous baseline the paper contrasts with asynchronous methods
    ("One drawback of SH and Hyperband is their synchronous nature").
    """

    def __init__(self, config: HyperbandConfig = HyperbandConfig()):
        self.config = config

    def brackets(self) -> List[List[Dict[str, int]]]:
        """Return every bracket as its list of rungs {n, r}."""
        eta, r_max = self.config.eta, self.config.r_max
        s_max = int(np.floor(np.log(r_max) / np.log(eta)))
        out = []
        for s in range(s_max, -1, -1):
            n = int(np.ceil((s_max + 1) / (s + 1) * eta**s))
            r = r_max * eta ** (-s)
            rungs = []
            for i in range(s + 1):
                rungs.append({
                    "n": max(1, int(np.floor(n * eta ** (-i)))),
                    "r": int(r * eta**i),
                })
            out.append(rungs)
        return out

    @staticmethod
    def promote(results: Sequence[float], eta: int) -> List[int]:
        """Indices of the top 1/eta configs (minimization)."""
        keep = max(1, len(results) // eta)
        order = np.argsort(np.asarray(results))
        return [int(i) for i in order[:keep]]
