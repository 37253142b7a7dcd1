"""Execution backends for tuning jobs (paper §3.2).

The AMT backend runs each candidate as a SageMaker training job; here the
``Backend`` protocol abstracts "the training platform". Two implementations:

* ``ThreadBackend`` — real asynchronous execution on a thread pool. The
  objective is a *live* callable ``fn(config, report) -> float`` that calls
  ``report(value)`` after every training iteration; ``report`` returns False
  when the tuner has requested a cooperative stop (median rule / straggler
  timeout). XLA releases the GIL during computation, so trials genuinely
  overlap on CPU and on multi-device hosts.

* ``SimBackend`` — a deterministic discrete-event simulator. The objective is
  a *curve* callable ``fn(config) -> (values, iter_costs)`` giving the metric
  after each iteration and the (virtual) seconds each iteration takes. This
  reproduces cluster-scale behaviour — async slot refill, early-stopping time
  savings (paper Fig. 4), stragglers, failure/retry — exactly and instantly
  on CPU. Failure injection: ``failure_fn(trial, attempt) -> fail_after_frac``
  returns None (no failure) or the fraction of the curve after which the
  (virtual) node dies.

Both emit the same ``TrialEvent`` stream, so the Tuner is backend-agnostic.
"""

from __future__ import annotations

import heapq
import itertools
import queue
import threading
import time as _time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.trial import Trial

__all__ = ["TrialEvent", "ThreadBackend", "SimBackend", "TrialStopRequested"]


class TrialEvent(NamedTuple):
    kind: str  # "started" | "report" | "completed" | "failed"
    trial_id: int
    time: float
    iteration: int = 0
    value: float = float("nan")
    error: str = ""
    # named metric dict attached to "completed" events of multi-metric jobs
    # (objective + constraint metrics, raw per-goal values)
    metrics: Optional[Dict[str, float]] = None


class TrialStopRequested(Exception):
    """Raised inside a live objective when the tuner requests a stop."""


# --------------------------------------------------------------------------
# Thread backend: real async execution
# --------------------------------------------------------------------------
class ThreadBackend:
    """Runs live objectives ``fn(config, report) -> float`` on worker threads."""

    def __init__(self, max_workers: int = 8):
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self._events: "queue.Queue[TrialEvent]" = queue.Queue()
        self._stop_flags: Dict[int, threading.Event] = {}
        self._active: Dict[int, Any] = {}
        self._lock = threading.Lock()
        self._t0 = _time.monotonic()

    def now(self) -> float:
        return _time.monotonic() - self._t0

    def active_count(self) -> int:
        with self._lock:
            return len(self._active)

    def submit(self, trial: Trial, objective: Callable) -> None:
        flag = threading.Event()
        with self._lock:
            self._stop_flags[trial.trial_id] = flag

        def run() -> None:
            self._events.put(TrialEvent("started", trial.trial_id, self.now()))
            it = itertools.count(1)

            def report(value: float) -> bool:
                i = next(it)
                self._events.put(
                    TrialEvent("report", trial.trial_id, self.now(), i, float(value))
                )
                return not flag.is_set()

            try:
                final = objective(dict(trial.config), report)
                if isinstance(final, dict):
                    # multi-metric objective: a named metric dict. The tuner
                    # resolves the objective via its MetricSet; the scalar
                    # ``value`` channel stays NaN (there is no single value).
                    self._events.put(
                        TrialEvent(
                            "completed", trial.trial_id, self.now(),
                            metrics={k: float(v) for k, v in final.items()},
                        )
                    )
                else:
                    self._events.put(
                        TrialEvent(
                            "completed", trial.trial_id, self.now(),
                            value=float(final),
                        )
                    )
            except TrialStopRequested:
                self._events.put(
                    TrialEvent("completed", trial.trial_id, self.now(), value=float("nan"))
                )
            except Exception:  # noqa: BLE001 — report, never crash the tuner
                self._events.put(
                    TrialEvent(
                        "failed",
                        trial.trial_id,
                        self.now(),
                        error=traceback.format_exc(limit=4),
                    )
                )
            finally:
                with self._lock:
                    self._active.pop(trial.trial_id, None)
                    self._stop_flags.pop(trial.trial_id, None)

        with self._lock:
            self._active[trial.trial_id] = self._pool.submit(run)

    def request_stop(self, trial_id: int) -> None:
        with self._lock:
            flag = self._stop_flags.get(trial_id)
        if flag is not None:
            flag.set()

    def next_event(self, timeout: Optional[float] = None) -> Optional[TrialEvent]:
        try:
            return self._events.get(timeout=timeout)
        except queue.Empty:
            return None

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)


# --------------------------------------------------------------------------
# Discrete-event simulator: deterministic virtual time
# --------------------------------------------------------------------------
class _SimTrial:
    __slots__ = (
        "trial", "values", "costs", "next_iter", "stop", "fail_after",
        "metrics",
    )

    def __init__(self, trial, values, costs, fail_after, metrics=None):
        self.trial = trial
        self.values = values
        self.costs = costs
        self.next_iter = 0  # 0-based index of the next report
        self.stop = False
        self.fail_after = fail_after  # iteration index after which node dies
        self.metrics = metrics  # named metric dict for the completion event


class SimBackend:
    """Deterministic discrete-event backend over virtual time.

    objective: ``fn(config) -> (values, iter_costs)`` where ``values`` is the
    per-iteration metric sequence and ``iter_costs`` a scalar or per-iteration
    seconds. ``startup_cost`` models cluster provisioning overhead (paper
    §3.3: cluster setup "introduced an overhead that was pronounced for
    smaller datasets").
    """

    def __init__(
        self,
        startup_cost: float = 0.0,
        failure_fn: Optional[Callable[[Trial, int], Optional[float]]] = None,
    ):
        self._heap: list = []  # (time, seq, trial_id)
        self._seq = itertools.count()
        self._sim: Dict[int, _SimTrial] = {}
        self._clock = 0.0
        self.startup_cost = startup_cost
        self.failure_fn = failure_fn
        self._pending_events: list[TrialEvent] = []

    def now(self) -> float:
        return self._clock

    def advance_clock(self, t: float) -> None:
        """Fast-forward virtual time (the tuner uses this when the only
        remaining work is retry-queued behind a backoff deadline — otherwise
        the clock, which only moves on events, would stall forever)."""
        self._clock = max(self._clock, t)

    def active_count(self) -> int:
        return len(self._sim)

    def submit(self, trial: Trial, objective: Callable) -> None:
        result = objective(dict(trial.config))
        # 2-tuple: (curve, costs); 3-tuple additionally carries the named
        # metric dict attached to the completion event (multi-metric jobs).
        metrics = None
        if len(result) == 3:
            values, costs, metrics = result
            metrics = {k: float(v) for k, v in metrics.items()}
        else:
            values, costs = result
        values = np.asarray(list(values), dtype=np.float64)
        costs = np.broadcast_to(
            np.asarray(costs, dtype=np.float64), values.shape
        ).copy()
        fail_after = None
        if self.failure_fn is not None:
            frac = self.failure_fn(trial, trial.attempts)
            if frac is not None:
                fail_after = max(0, int(np.floor(frac * len(values))))
        st = _SimTrial(trial, values, costs, fail_after, metrics)
        self._sim[trial.trial_id] = st
        self._pending_events.append(
            TrialEvent("started", trial.trial_id, self._clock)
        )
        first_t = self._clock + self.startup_cost + float(costs[0]) if len(values) else self._clock
        if fail_after == 0:
            heapq.heappush(
                self._heap, (self._clock + self.startup_cost, next(self._seq), trial.trial_id, "fail")
            )
        elif len(values):
            heapq.heappush(self._heap, (first_t, next(self._seq), trial.trial_id, "report"))
        else:
            heapq.heappush(
                self._heap, (self._clock + self.startup_cost, next(self._seq), trial.trial_id, "complete")
            )

    def request_stop(self, trial_id: int) -> None:
        st = self._sim.get(trial_id)
        if st is not None:
            st.stop = True

    def next_event(self, timeout: Optional[float] = None) -> Optional[TrialEvent]:
        if self._pending_events:
            return self._pending_events.pop(0)
        while self._heap:
            t, _, tid, kind = heapq.heappop(self._heap)
            st = self._sim.get(tid)
            if st is None:
                continue
            self._clock = max(self._clock, t)
            if kind == "fail":
                del self._sim[tid]
                return TrialEvent(
                    "failed", tid, self._clock, error="SimBackend: injected node failure"
                )
            if kind == "complete":
                del self._sim[tid]
                final = float(st.values[-1]) if len(st.values) else float("nan")
                return TrialEvent(
                    "completed", tid, self._clock, value=final,
                    metrics=st.metrics,
                )
            # kind == "report"
            i = st.next_iter
            value = float(st.values[i])
            st.next_iter += 1
            st.trial.resource_used = st.next_iter
            done = st.next_iter >= len(st.values)
            if st.stop:
                # cooperative stop lands *before* scheduling further work
                del self._sim[tid]
                self._pending_events.append(
                    TrialEvent("completed", tid, self._clock, value=float("nan"))
                )
                return TrialEvent("report", tid, self._clock, i + 1, value)
            if st.fail_after is not None and st.next_iter >= st.fail_after:
                heapq.heappush(self._heap, (self._clock, next(self._seq), tid, "fail"))
                return TrialEvent("report", tid, self._clock, i + 1, value)
            if done:
                heapq.heappush(self._heap, (self._clock, next(self._seq), tid, "complete"))
            else:
                nt = self._clock + float(st.costs[st.next_iter])
                heapq.heappush(self._heap, (nt, next(self._seq), tid, "report"))
            return TrialEvent("report", tid, self._clock, i + 1, value)
        return None

    def shutdown(self) -> None:
        self._heap.clear()
        self._sim.clear()
