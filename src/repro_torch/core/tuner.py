"""The tuning-job workflow engine (paper §3).

Maps the AMT service architecture (Fig. 1) onto a single, checkpointable
control loop:

  * Hyperparameter Selection Service  → ``suggester`` (BO / random / Sobol)
  * SageMaker Training platform        → ``backend`` (threads or sim)
  * Workflow engine (StepFunctions)    → ``Tuner.run`` event loop
  * DynamoDB metadata store            → ``Tuner.save`` / ``Tuner.restore``
    (JSON; *metadata only* — trial payloads/models live with the training
    side, mirroring the paper's "no customer data in DynamoDB" principle)

Decision-path architecture: the tuner owns an ``ObservationStore``
(``repro_torch.core.history``) and *pushes state transitions into it on events* —
observation appended when a trial reaches COMPLETED/STOPPED with a finite
objective, pending marked at submit and cleared at terminality. Suggesters
that support it (``BOSuggester``) are bound to the store at construction and
serve decisions incrementally from cached GP state; warm-start parent
observations are folded into the store once, not re-encoded per decision.
Slot refill is *batched*: all free slots are computed up front and filled by
one ``suggest_batch(k)`` call, so K simultaneously freed slots cost one
engine pass instead of K (paper §4.4 at fleet scale).

Features implemented per the paper:
  * asynchronous slot refill (§4.4): as soon as an evaluation finishes, the
    GP is updated and the freed slot is filled, never re-proposing pending
    candidates;
  * automated early stopping (§5.2): a pluggable stopping rule (median rule
    by default; ASHA as a beyond-paper alternative) watched on every report;
  * warm start (§5.3): parent-job observations are folded into the
    suggester's history, z-scored per task;
  * fault tolerance (§3.3): failed trials retry with exponential backoff up
    to ``max_retries``; tuner state is checkpointed after every transition,
    and ``Tuner.restore`` resumes a killed job;
  * straggler mitigation: per-trial wall/virtual-time budget — over-budget
    trials are stopped (yielding their best-so-far) instead of blocking slots;
  * elasticity: ``max_parallel`` may be changed while running (the slot pool
    grows/shrinks without invalidating tuner or GP state).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.history import ObservationStore
from repro_torch.core.trial import Trial, TrialState
from repro_torch.core.warm_start import WarmStartPool

__all__ = ["TuningJobConfig", "TuningResult", "Tuner"]


@dataclasses.dataclass
class TuningJobConfig:
    """Per-job knobs of the tuning workflow (paper §3).

    Args:
        max_trials: total unique configurations to evaluate (retries of a
            failed attempt do not count).
        max_parallel: concurrent evaluation slots; may be changed on a live
            ``Tuner`` (elasticity) without invalidating engine state.
        max_retries: failed-attempt retries per trial before it is marked
            FAILED (§3.3). Crash-restore re-runs do not consume this budget.
        retry_backoff: base of the exponential retry backoff, in backend
            seconds (virtual for ``SimBackend``).
        trial_timeout: straggler budget per trial, in backend seconds; an
            over-budget trial is stopped (keeping its best-so-far) instead of
            blocking its slot. None disables.
        checkpoint_path: JSON checkpoint target for ``Tuner.save`` /
            ``Tuner.restore``; checkpointing happens after every event when
            set. None disables.
        seed: seed for the service-created suggester (service mode) and any
            seeded suggester construction.
        job_name: registry key in service mode — concurrent jobs on one
            ``SelectionService``/``RemoteService`` need distinct names.
        metrics: optional tuple of ``repro_torch.core.multimetric.MetricSpec``
            declaring the job's named metrics (objective first; constraints
            after). Trials then report a metric dict at completion — the
            objective returns ``{"val_loss": ..., "latency_ms": ...}``
            (``ThreadBackend``) or a ``(curve, costs, metrics)`` 3-tuple
            (``SimBackend``). With constraints declared, ``best_trial`` is
            the best *feasible* trial; with ≥ 2 objectives the engine runs
            Pareto mode and ``TuningResult.pareto_front`` tracks the
            non-dominated set. None (default) is exactly the single-metric
            job of the paper.
    """

    max_trials: int = 20
    max_parallel: int = 1
    max_retries: int = 2
    retry_backoff: float = 1.0  # seconds (virtual for SimBackend) per attempt
    trial_timeout: Optional[float] = None  # straggler budget per trial
    checkpoint_path: Optional[str] = None
    seed: int = 0
    job_name: str = "tuning-job"
    metrics: Optional[Tuple] = None  # Tuple[MetricSpec, ...]
    # multi-fidelity mode (``repro_torch.core.asha.ASHAConfig``): promote/stop
    # decisions are made *inside* the selection service at each rung crossing
    # (``JobHandle.report_rung``), and the engine scores candidates with
    # per-rung GP heads over the shared factor (``core/gp/per_resource``).
    # Service mode only; mutually exclusive with a client-side
    # ``stopping_rule``. None (default) disables — bit-identical to the
    # fixed-fidelity engine.
    multi_fidelity: Optional[Any] = None  # ASHAConfig
    # budget enforcement (``repro_torch.core.budget``): max_cost caps the summed
    # per-trial cost (backend seconds between start and terminal events —
    # virtual under SimBackend); max_wallclock caps the backend clock itself.
    # Both gate *new* launches only: in-flight trials and retry re-runs finish
    # (bounded overspend — at most one in-flight trial per slot). None
    # (default) disables; cost-off jobs are bit-identical to the pre-budget
    # engine.
    max_cost: Optional[float] = None
    max_wallclock: Optional[float] = None


@dataclasses.dataclass
class TuningResult:
    """Outcome of one ``Tuner.run``.

    Attributes:
        trials: every trial, sorted by ``trial_id`` (terminal and otherwise).
        best_trial: lowest-objective COMPLETED/STOPPED trial, or None.
        timeline: (backend time, best objective so far) after each terminal
            event — the anytime-performance curve of paper Fig. 3.
        total_time: backend clock at the end of the run (virtual seconds for
            ``SimBackend``).
        total_iterations: training resource actually consumed across all
            trials (sum of per-trial iterations reported).
        num_early_stopped: trials stopped by the stopping rule (§5.2) or the
            straggler budget.
        num_failed_attempts: failed executions including retried attempts
            (infrastructure failures like a dead engine replica do not count;
            see ``tests/test_remote_service.py``).
        pareto_front: jobs with a metric declaration only — the
            non-dominated set of COMPLETED trials over the *objective*
            metrics (signed into the minimize convention; restricted to
            feasible trials when constraints are declared), sorted by trial
            id. Empty when ``TuningJobConfig.metrics`` is None (undeclared
            jobs). With a single objective (declared single-metric or
            constrained mode) it degenerates to the best (feasible)
            trial(s).
    """

    trials: List[Trial]
    best_trial: Optional[Trial]
    timeline: List[Tuple[float, float]]  # (time, best objective so far)
    total_time: float
    total_iterations: int  # resource actually consumed
    num_early_stopped: int
    num_failed_attempts: int
    pareto_front: List[Trial] = dataclasses.field(default_factory=list)

    @property
    def best_config(self) -> Optional[Dict[str, Any]]:
        return None if self.best_trial is None else dict(self.best_trial.config)

    @property
    def best_objective(self) -> float:
        return float("inf") if self.best_trial is None else self.best_trial.objective

    def history(self) -> List[Tuple[Dict[str, Any], float]]:
        return [
            (dict(t.config), t.objective)
            for t in self.trials
            if t.state in (TrialState.COMPLETED, TrialState.STOPPED)
            and math.isfinite(t.objective)
        ]


class Tuner:
    """Orchestrates one hyperparameter tuning job (minimization).

    Args:
        space: the job's ``SearchSpace``.
        objective: evaluation callable handed to the backend. For
            ``SimBackend`` it maps a config dict to ``(learning curve, cost
            per iteration)``; for ``ThreadBackend`` it runs the real training.
        suggester: decision engine (``BOSuggester``, ``RandomSuggester``, …).
            In service mode pass None to let the service create one from its
            ``default_bo_config`` (required for ``RemoteService`` — a local
            suggester object cannot cross the process boundary).
        backend: execution backend (``SimBackend`` / ``ThreadBackend``).
        job_config: the ``TuningJobConfig`` knobs.
        stopping_rule: optional early-stopping rule watched on every report
            (median rule, ASHA — §5.2).
        warm_start: optional ``WarmStartPool`` of parent-job observations,
            folded into the GP dataset once (§5.3).
        callbacks: ``f(tuner, trial)`` hooks invoked at each trial's
            terminal event.
        service: optional ``SelectionService`` (in-process) or
            ``repro.distributed.RemoteService`` (engine-replica fleet over
            sockets). When set, the store and engine cache are service-owned,
            registration folds sibling warm-start in, and slot refill routes
            through ``JobHandle.suggest_batch`` — the RPC seam. Both service
            types produce identical trial tables for identical inputs (the
            wire protocol is exact; see ``docs/wire_protocol.md``).

    ``run()`` returns a ``TuningResult``; ``save()``/``restore()`` checkpoint
    and resume a job bit-identically (including in remote service mode).
    """

    def __init__(
        self,
        space,
        objective: Callable,
        suggester,
        backend,
        job_config: TuningJobConfig = TuningJobConfig(),
        stopping_rule=None,
        warm_start: Optional[WarmStartPool] = None,
        callbacks: Sequence[Callable[["Tuner", Trial], None]] = (),
        service=None,
    ):
        self.space = space
        self.objective = objective
        self.suggester = suggester
        self.backend = backend
        self.config = job_config
        self.stopping_rule = stopping_rule
        self.warm_start = warm_start
        self.callbacks = list(callbacks)
        # multi-metric declaration (repro_torch.core.multimetric): None for the
        # paper's single-metric job.
        if job_config.metrics:
            raise NotImplementedError(
                "multi-metric jobs are not ported yet (ROADMAP queue A item 8)"
            )
        self.metric_set = None
        # stopping rules predate trial-id keying; detect support once so old
        # custom rules (positional should_stop(curve)) keep working.
        self._rule_stop_keyed = self._accepts_trial_id(
            getattr(stopping_rule, "should_stop", None)
        )
        self._rule_rec_keyed = self._accepts_trial_id(
            getattr(stopping_rule, "record_completed", None)
        )
        # multi-fidelity (ASHA-in-service; repro_torch.core.multifidelity): rung
        # crossings route through JobHandle.report_rung; the service owns the
        # rung tables and the promote/stop decisions.
        self.multi_fidelity = job_config.multi_fidelity
        self._mf_rungs: set[int] = set()
        if self.multi_fidelity is not None:
            if service is None:
                raise ValueError(
                    "multi_fidelity requires service mode (pass service=...)"
                )
            if stopping_rule is not None:
                raise ValueError(
                    "multi_fidelity replaces stopping_rule — pass one, not both"
                )
            if self.metric_set is not None and self.metric_set.num_metrics > 1:
                raise ValueError(
                    "multi_fidelity supports single-metric jobs only"
                )
            raise NotImplementedError(
                "multi-fidelity jobs are not ported yet (ROADMAP queue A item 9)"
            )
        # service mode (paper §3 Fig. 1): decisions route through a shared
        # SelectionService — store/cache are service-owned, siblings on the
        # same space pool GPHP samples and warm-start each other.
        self.service = service
        self._service_handle = None
        self._warm_start_restored = False

        self.trials: Dict[int, Trial] = {}
        self._next_id = 0
        self._submitted = 0  # counts unique configs tried (retries excluded)
        self._stop_requested: set[int] = set()
        # (not-before time, trial, counts_attempt): counts_attempt is False for
        # crash-restore re-runs of in-flight trials — re-executing work the
        # job lost must not consume the failure retry budget (§3.3).
        self._retry_queue: List[Tuple[float, Trial, bool]] = []
        self._timeline: List[Tuple[float, float]] = []
        self._num_failed_attempts = 0
        self.max_parallel = job_config.max_parallel
        # budget ledger (repro_torch.core.budget): created by _new_store when the
        # job declares max_cost or a cost-aware suggester; charged from
        # backend event times at trial terminality. None keeps every code
        # path bit-identical to the pre-budget engine.
        self.budget_ledger = None
        self.store = self._new_store()
        # track per-trial costs (pushed into the store, feeding the cost
        # head) only when something consumes them — cost-off jobs keep
        # byte-identical store/checkpoint state.
        self._track_cost = self.budget_ledger is not None

    # ------------------------------------------------------- stopping rules
    @staticmethod
    def _accepts_trial_id(fn) -> bool:
        if fn is None:
            return False
        import inspect

        try:
            return "trial_id" in inspect.signature(fn).parameters
        except (TypeError, ValueError):
            return False

    def _rule_curve(self, trial: Trial) -> List[float]:
        """The trial's curve signed into the minimize convention the rules
        assume. For a declared maximize objective the raw curve carries the
        wrong sign — feeding it unsigned makes the rules stop the *best*
        trials (consistent with the resolved-metric convention of the
        multi-metric layer)."""
        sign = 1.0 if self.metric_set is None else self.metric_set.specs[0].sign
        if sign == 1.0:
            return trial.curve
        return [sign * v for v in trial.curve]

    def _rule_should_stop(self, trial: Trial) -> bool:
        curve = self._rule_curve(trial)
        if self._rule_stop_keyed:
            return self.stopping_rule.should_stop(
                curve, trial_id=trial.trial_id
            )
        return self.stopping_rule.should_stop(curve)

    def _rule_record_completed(self, trial: Trial) -> None:
        curve = self._rule_curve(trial)
        if self._rule_rec_keyed:
            self.stopping_rule.record_completed(
                curve, trial_id=trial.trial_id
            )
        else:
            self.stopping_rule.record_completed(curve)

    # ------------------------------------------------------------- history
    def _new_store(self) -> ObservationStore:
        """Fresh observation store (warm-start parents folded in once); bind
        it to the suggester so decisions are served incrementally. In service
        mode the store (sibling warm-start folded in) and the engine cache
        are created by the service; the combined warm-start pool becomes this
        tuner's ``warm_start`` so checkpoints capture the sibling parents
        exactly as registered (restore must not re-fold a moved target)."""
        if self.service is not None:
            raise NotImplementedError(
                "service mode is not ported yet (ROADMAP queue A item 7)"
            )
        store = ObservationStore(
            self.space, warm_start=self.warm_start, metrics=self.metric_set
        )
        if hasattr(self.suggester, "bind_store"):
            self.suggester.bind_store(store)
        cost_aware = bool(
            getattr(getattr(self.suggester, "config", None), "cost_aware", False)
        )
        if self.config.max_cost is not None or cost_aware:
            raise NotImplementedError(
                "budgets and cost-aware jobs are not ported yet (ROADMAP "
                "queue A item 6: core/budget.py)"
            )
        self.budget_ledger = None
        return store

    def _observe_terminal(self, trial: Trial) -> None:
        """Event-sourced store transition at trial terminality. FAILED or
        non-finite trials only clear their pending slot: their curve minima
        are measurements at the moment of death, not final objectives — they
        must neither seed the GP nor win the job. Multi-metric jobs push the
        full named vector; a trial that completed without its metric dict
        (early-stopped, or a misbehaving objective) cannot seed the GP —
        constraint heads have no value to impute."""
        self.store.clear_pending(trial.trial_id)
        # per-trial cost: backend event time between start and terminality —
        # never a wall clock (the budget-clock invariant; replayed runs must
        # observe identical spend). Charged for every terminal trial (failed
        # ones spent the budget too), pushed into the store only for rows
        # that seed the GP.
        cost = None
        if (
            self._track_cost
            and trial.start_time is not None
            and trial.end_time is not None
        ):
            cost = max(0.0, trial.end_time - trial.start_time)
        if cost is not None and cost > 0.0:
            self._charge_cost(cost)
        if trial.state not in (TrialState.COMPLETED, TrialState.STOPPED):
            return
        if self.metric_set is not None and self.metric_set.num_metrics > 1:
            if trial.metrics is None:
                return
            try:
                self.store.push_metrics(
                    trial.config, trial.metrics, key=trial.trial_id
                )
            except KeyError:
                pass  # missing metric name: row cannot seed the GP
            return
        if self._objective_usable(trial) and math.isfinite(trial.objective):
            self.store.push(
                trial.config, trial.objective, key=trial.trial_id, cost=cost
            )

    def _charge_cost(self, cost: float) -> None:
        """Record one terminal trial's spend on the job's ledger. In remote
        service mode the charge crosses the wire (the replica's ledger rides
        its snapshots) and the handle keeps its mirror in lock-step."""
        if self._service_handle is not None and hasattr(
            self._service_handle, "observe_charge"
        ):
            self._service_handle.observe_charge(cost)
        elif self.budget_ledger is not None:
            self.budget_ledger.charge(cost)

    def _objective_usable(self, trial: Trial) -> bool:
        """Is ``trial.objective`` trustworthy for ranking/seeding? For a
        declared maximize objective (or any M > 1 job) only the resolved
        metric dict carries the right sign — the raw curve stream does not,
        so a trial without one (early-STOPPED, misbehaving objective) has no
        usable objective. Declared minimize single metrics keep the legacy
        curve semantics (the M=1 bit-equivalence contract)."""
        ms = self.metric_set
        if ms is None:
            return True
        if ms.num_metrics > 1 or ms.specs[0].goal == "maximize":
            return trial.objective_from_metrics is not None
        return True

    # ---------------------------------------------------------------- main
    def run(self) -> TuningResult:
        idle = 0
        while True:
            self._requeue_retries()
            self._refill_slots()
            if self._all_done():
                break
            ev = self.backend.next_event(timeout=5.0)
            if ev is None:
                # No event: either workers are still busy (keep waiting) or
                # everything finished and the queue momentarily looks empty —
                # drain defensively before concluding (ThreadBackend workers
                # enqueue their final event *before* releasing the slot, but
                # the tuner may observe the two out of order under load).
                self._drain_events()
                if self._all_done():
                    break
                if self.backend.active_count() == 0 and self._retry_queue:
                    # liveness: the only remaining work sits behind retry
                    # backoffs — on a virtual-clock backend time only moves
                    # with events, so fast-forward to the earliest deadline.
                    earliest = min(t for t, _, _ in self._retry_queue)
                    if hasattr(self.backend, "advance_clock"):
                        self.backend.advance_clock(earliest)
                    continue
                idle += 1
                if (
                    idle > 24
                    and self.backend.active_count() == 0
                    and not self._retry_queue
                ):
                    break  # stuck trials: give up; result() reports them
                continue
            idle = 0
            self._handle_event(ev)
            self._check_stragglers()
            self._checkpoint()
        self._drain_events()
        self._checkpoint()
        return self.result()

    def _drain_events(self) -> None:
        while True:
            ev = self.backend.next_event(timeout=0.05)
            if ev is None:
                return
            self._handle_event(ev)

    # ---------------------------------------------------------- event flow
    def _refill_slots(self) -> None:
        """Compute all free slots up front and fill them with one batched
        suggester pass (one GP pipeline for K freed slots instead of K)."""
        if self._budget_stop():
            # budgets gate *new* launches only — in-flight trials and queued
            # retries run to completion (bounded overspend).
            return
        free = min(
            self.max_parallel - self.backend.active_count(),
            self.config.max_trials - self._submitted,
        )
        if free <= 0:
            return
        if self._service_handle is not None:
            # service mode: decisions go through the selection service — in
            # process via JobHandle, or over the wire via RemoteJobHandle
            # (repro.distributed), which serves the same surface.
            for config in self._service_handle.suggest_batch(free):
                self._launch(config)
        elif hasattr(self.suggester, "suggest_batch"):
            for config in self.suggester.suggest_batch(free):
                self._launch(config)
        else:
            # stateless suggesters get the store-derived history view per slot
            for _ in range(free):
                config = self.suggester.suggest(
                    self.store.history_pairs(), self.store.pending_configs()
                )
                self._launch(config)

    def _launch(self, config: Dict[str, Any]) -> None:
        trial = Trial(
            trial_id=self._next_id,
            config=dict(config),
            submit_time=self.backend.now(),
        )
        self._next_id += 1
        self._submitted += 1
        self.trials[trial.trial_id] = trial
        trial.state = TrialState.RUNNING
        trial.attempts = 1
        self.store.mark_pending(trial.trial_id, trial.config)
        self.backend.submit(trial, self.objective)

    def _requeue_retries(self) -> None:
        now = self.backend.now()
        still_waiting = []
        for not_before, trial, counts_attempt in self._retry_queue:
            if now >= not_before and self.backend.active_count() < self.max_parallel:
                trial.state = TrialState.RUNNING
                if counts_attempt:
                    trial.attempts += 1
                else:  # crash-restore re-run: same attempt, re-executed
                    trial.attempts = max(trial.attempts, 1)
                trial.error = None
                trial.curve = []
                self.backend.submit(trial, self.objective)
            else:
                still_waiting.append((not_before, trial, counts_attempt))
        self._retry_queue = still_waiting

    def _handle_event(self, ev) -> None:
        trial = self.trials.get(ev.trial_id)
        if trial is None:
            return
        if ev.kind == "started":
            trial.start_time = ev.time
        elif ev.kind == "report":
            trial.curve.append(ev.value)
            trial.resource_used = max(trial.resource_used, ev.iteration)
            if (
                self._mf_rungs
                and ev.trial_id not in self._stop_requested
                and len(trial.curve) in self._mf_rungs
            ):
                # rung crossing: the service owns the promote/stop decision
                # (idempotent per (trial, rung) — restore replays get the
                # original decision back). Value = signed running best.
                decision = self._service_handle.report_rung(
                    ev.trial_id,
                    len(trial.curve),
                    float(min(self._rule_curve(trial))),
                )
                if decision == "stop":
                    self._stop_requested.add(ev.trial_id)
                    self.backend.request_stop(ev.trial_id)
            if (
                self.stopping_rule is not None
                and ev.trial_id not in self._stop_requested
                and self._rule_should_stop(trial)
            ):
                self._stop_requested.add(ev.trial_id)
                self.backend.request_stop(ev.trial_id)
        elif ev.kind == "completed":
            trial.end_time = ev.time
            if math.isfinite(ev.value):
                trial.final_objective = ev.value
            if ev.metrics is not None:
                trial.metrics = dict(ev.metrics)
                if self.metric_set is not None:
                    # resolve the scalar objective (signed into the engine's
                    # minimize convention) from the named dict
                    ms = self.metric_set
                    spec0 = ms.specs[0]
                    val = trial.metrics.get(spec0.name)
                    if val is not None and math.isfinite(float(val)):
                        trial.final_objective = spec0.sign * float(val)
                        # The dict is authoritative for M>1 and for maximize
                        # goals (raw curve values carry the wrong sign there;
                        # min() over them would corrupt ranking/seeding). For
                        # a declared minimize single metric we keep the
                        # legacy min(final, curve) semantics — the M=1
                        # bit-equivalence contract with undeclared jobs.
                        if ms.num_metrics > 1 or spec0.goal == "maximize":
                            trial.objective_from_metrics = (
                                spec0.sign * float(val)
                            )
            if ev.trial_id in self._stop_requested:
                trial.state = TrialState.STOPPED
                trial.stopped_early = True
                self._stop_requested.discard(ev.trial_id)
            else:
                trial.state = TrialState.COMPLETED
                if self.stopping_rule is not None and trial.curve:
                    self._rule_record_completed(trial)
            self._observe_terminal(trial)
            self._record_timeline(ev.time)
            for cb in self.callbacks:
                cb(self, trial)
        elif ev.kind == "failed":
            self._num_failed_attempts += 1
            if trial.attempts <= self.config.max_retries:
                backoff = self.config.retry_backoff * (2 ** (trial.attempts - 1))
                trial.state = TrialState.PENDING
                trial.error = ev.error
                self._retry_queue.append((ev.time + backoff, trial, True))
            else:
                trial.state = TrialState.FAILED
                trial.end_time = ev.time
                trial.error = ev.error
                self._observe_terminal(trial)
                self._record_timeline(ev.time)
                for cb in self.callbacks:
                    cb(self, trial)

    def _check_stragglers(self) -> None:
        budget = self.config.trial_timeout
        if budget is None:
            return
        now = self.backend.now()
        for t in self.trials.values():
            if (
                t.state == TrialState.RUNNING
                and t.start_time is not None
                and now - t.start_time > budget
                and t.trial_id not in self._stop_requested
            ):
                self._stop_requested.add(t.trial_id)
                self.backend.request_stop(t.trial_id)

    def _record_timeline(self, t: float) -> None:
        best = min(
            (
                tr.objective
                for tr in self.trials.values()
                if tr.state in (TrialState.COMPLETED, TrialState.STOPPED)
                and self._objective_usable(tr)
            ),
            default=float("inf"),
        )
        self._timeline.append((t, best))

    def _budget_stop(self) -> bool:
        """Has the job run out of budget? max_cost via the ledger; the
        wall-clock cap reads the *backend* clock (virtual under SimBackend) —
        budget code never reads a real clock."""
        if self.budget_ledger is not None and self.budget_ledger.exhausted:
            return True
        return (
            self.config.max_wallclock is not None
            and self.backend.now() >= self.config.max_wallclock
        )

    def _all_done(self) -> bool:
        if not self._budget_stop():
            if self._submitted < self.config.max_trials:
                return False
        if self._retry_queue:
            return False
        return all(t.is_terminal for t in self.trials.values())

    # ------------------------------------------------------------- results
    def result(self) -> TuningResult:
        terminal = [t for t in self.trials.values() if t.is_terminal]
        eligible = [
            t for t in terminal
            if t.state in (TrialState.COMPLETED, TrialState.STOPPED)
            and self._objective_usable(t)
            and math.isfinite(t.objective)
        ]
        ms = self.metric_set
        if ms is not None and ms.num_constraints > 0:
            feasible = [
                t for t in eligible
                if t.metrics is not None and ms.feasible(t.metrics)
            ]
            # best *feasible* trial; with nothing feasible yet, fall back to
            # the unconstrained best so the job still reports progress.
            pool = feasible if feasible else eligible
        else:
            pool = eligible
        best = min(pool, key=lambda t: t.objective) if pool else None
        return TuningResult(
            trials=sorted(self.trials.values(), key=lambda t: t.trial_id),
            best_trial=best,
            timeline=list(self._timeline),
            total_time=self.backend.now(),
            total_iterations=sum(t.resource_used for t in self.trials.values()),
            num_early_stopped=sum(1 for t in terminal if t.stopped_early),
            num_failed_attempts=self._num_failed_attempts,
            pareto_front=self._pareto_front(),
        )

    def _pareto_front(self) -> List[Trial]:
        """Non-dominated COMPLETED trials over the objective metrics (signed;
        feasible-only when constraints are declared). See
        ``TuningResult.pareto_front``."""
        ms = self.metric_set
        if ms is None:
            return []
        raise NotImplementedError(
            "multi-metric jobs are not ported yet (ROADMAP queue A item 8)"
        )

    # -------------------------------------------------------- persistence
    def save(self, path: Optional[str] = None) -> None:
        path = path or self.config.checkpoint_path
        if path is None:
            return
        state = {
            "job_name": self.config.job_name,
            "next_id": self._next_id,
            "submitted": self._submitted,
            "timeline": self._timeline,
            "num_failed_attempts": self._num_failed_attempts,
            "stop_requested": sorted(self._stop_requested),
            "trials": [t.to_json() for t in self.trials.values()],
            # store blob preserves the *push order* of observations, which the
            # trial table alone cannot (events may land out of trial-id order)
            # — required for bit-identical GP state after restore.
            "store": self.store.state_dict(),
            "suggester": type(self.suggester).__name__,
            "suggester_state": self.suggester.state_dict()
            if hasattr(self.suggester, "state_dict")
            else None,
            "stopping_rule_state": self.stopping_rule.state_dict()
            if self.stopping_rule is not None and hasattr(self.stopping_rule, "state_dict")
            else None,
            "warm_start_state": self.warm_start.state_dict()
            if self.warm_start is not None
            else None,
        }
        # budget ledger (key absent when budgets are off — cost-off
        # checkpoints stay byte-identical). For a BOSuggester the same values
        # also ride suggester_state["budget"]; this copy covers suggesters
        # without ledger state (random/Sobol under max_cost).
        if self.budget_ledger is not None:
            state["budget"] = self.budget_ledger.snapshot()
        # atomic write: never leave a torn checkpoint behind (paper §3:
        # resiliency as a guiding principle)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(state, f)
        os.replace(tmp, path)

    def _checkpoint(self) -> None:
        if self.config.checkpoint_path:
            self.save(self.config.checkpoint_path)

    def restore(self, path: Optional[str] = None) -> None:
        """Load tuner state; unfinished trials are re-queued for execution
        (at-least-once semantics, like the paper's retry workflow)."""
        path = path or self.config.checkpoint_path
        with open(path) as f:
            state = json.load(f)
        self._next_id = state["next_id"]
        self._submitted = state["submitted"]
        self._timeline = [tuple(x) for x in state["timeline"]]
        self._num_failed_attempts = state["num_failed_attempts"]
        # restore pending stop requests so a resumed job doesn't re-issue
        # stops for trials that were already asked to stop
        self._stop_requested = set(state.get("stop_requested", []))
        self.trials = {}
        for tj in state["trials"]:
            t = Trial.from_json(tj)
            if not t.is_terminal:
                # job died while this trial ran: re-run it (same config;
                # already counted in ``submitted``). The re-run starts from a
                # fresh curve, so any stop requested against the *old* attempt
                # must not suppress (or mislabel) the new one. A trial that
                # was RUNNING at the crash re-runs *without* consuming the
                # retry budget (it never failed); one that was PENDING *with
                # a recorded error* was awaiting a genuine failure retry and
                # still counts. (A crash-restore re-queue is also PENDING but
                # carries no error — attempts alone cannot distinguish the
                # two after a second crash.)
                was_retry_wait = t.state == TrialState.PENDING and t.error is not None
                t.state = TrialState.PENDING
                t.curve = []
                self._retry_queue.append((0.0, t, was_retry_wait))
                self._stop_requested.discard(t.trial_id)
            self.trials[t.trial_id] = t
        if state.get("warm_start_state"):
            self.warm_start = self.warm_start or WarmStartPool()
            self.warm_start.load_state_dict(state["warm_start_state"])
        elif self.service is not None:
            # checkpointed with *no* warm pool: discard whatever this
            # instance's __init__ registration folded from siblings' current
            # histories — the checkpoint is authoritative.
            self.warm_start = None
        # service mode: re-registering must not fold the siblings' *current*
        # histories on top of the restored pool (the GP dataset would shift
        # and break bit-identical restore).
        self._warm_start_restored = True
        # rebuild the observation store: parents from the (possibly restored)
        # warm-start pool, own rows from the checkpointed blob in push order,
        # pending slots from the re-queued trial table.
        self.store = self._new_store()
        if state.get("store"):
            self.store.load_state_dict(state["store"])
        else:  # older checkpoints: reconstruct from the trial table
            multi = self.metric_set is not None and self.metric_set.num_metrics > 1
            for t in sorted(self.trials.values(), key=lambda tr: tr.trial_id):
                if t.state not in (TrialState.COMPLETED, TrialState.STOPPED):
                    continue
                if multi:
                    if t.metrics is not None:
                        self.store.push_metrics(
                            t.config, t.metrics, key=t.trial_id
                        )
                elif math.isfinite(t.objective):
                    self.store.push(t.config, t.objective, key=t.trial_id)
        for _, t, _ in self._retry_queue:
            self.store.mark_pending(t.trial_id, t.config)
        if state.get("suggester_state") and hasattr(self.suggester, "load_state_dict"):
            self.suggester.load_state_dict(state["suggester_state"])
        if state.get("stopping_rule_state") and self.stopping_rule is not None:
            self.stopping_rule.load_state_dict(state["stopping_rule_state"])
        if state.get("budget") and self.budget_ledger is not None:
            self.budget_ledger.load_snapshot(state["budget"])
