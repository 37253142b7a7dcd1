"""Multi-job Hyperparameter Selection Service (paper §3, Fig. 1).

AMT's selection service is *multi-tenant*: one fleet of decision engines
serves many concurrent tuning jobs, and the fleet-scale story is amortizing
surrogate work across tenants (the same pattern SageMaker Autopilot leans on
when one AutoML run fans out many tuning jobs, and that SigOpt's multi-tenant
successor factors as shared modeling state across requests). Where
``BOSuggester`` is a fast *per-job* engine, ``SelectionService``
multiplexes N jobs over shared decision-engine state. Jobs registered on
the same search space (identical parameter structure ⇒ same encoded dim +
warpable dims) form a **space group** sharing three things:

  * **GPHP sample pool** (``GPHPSamplePool``) — slice-sampling is the
    dominant per-decision cost (paper §4.2). When a job's refit cadence
    triggers, it first checks whether a sibling published fresher draws since
    it last synced; if so it *adopts* them (a full refactorization, RNG-free)
    instead of re-running MCMC. Across a group of N jobs roughly one MCMC fit
    happens per ``refit_every`` *group* observations instead of one per job,
    and a cold job joining the group skips burn-in entirely (the pool also
    carries the last chain state, warm-starting the next chain). Adoption is
    an approximation — draws come from a sibling's posterior on the same
    space — and is disabled by ``ServiceConfig(share_gphp=False)``, which
    keeps every job's GPHP chain bit-identical to a standalone engine.

  * **Factor arena** (``FactorArena``) — per-suggester posterior caches were
    unbounded: each job pins O(S·n²) of Cholesky + L⁻¹ blocks forever. The
    arena is an LRU bound over every job's resident factors; eviction drops
    only the factor blocks (``EngineCache.drop_factors``), never the cached
    GPHP draws, so the next decision rebuilds deterministically without
    consuming RNG state — suggestions are invariant under eviction.

  * **Automatic sibling warm-start** (paper §5.3) — a job joining the
    service folds the *completed observations its siblings have so far* into
    its GP dataset via the existing ``WarmStartPool`` per-task z-scoring.
    This is live cross-job transfer: siblings registered before this job may
    still be running; whatever they have finished transfers. With
    ``share_gphp=False`` the resulting suggestions are exactly those of a
    standalone engine given an explicit ``WarmStartPool`` of the same
    histories (the equivalence tests pin this).

``Tuner(..., service=svc)`` routes a tuning job through the service: the
store, cache, and (optionally) the suggester itself are service-created, and
slot refill goes through ``JobHandle.suggest_batch`` — the RPC seam.
``SelectionService.snapshot_job`` / ``restore_job`` produce and adopt exact,
versioned engine snapshots (store + GPHP draws + cadence + pool, with the
O(S·n²) factor blocks optional because a restoring service rebuilds them
locally), in the JAX package's schema (``repro_torch.core.rpc``): a snapshot
taken by either package restores in the other. The cross-process
deployment of the seam lives in ``repro_torch.core.rpc`` (the versioned
wire protocol) and ``repro_torch.distributed.engine_server`` /
``engine_client`` (socket replicas with leases).

Suggesters the service creates run on the service's ``device`` (``None``:
the CUDA card; tests pass ``"cpu"``).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import telemetry
from repro_torch.core.history import ObservationStore
from repro_torch.core.search_space import Categorical, Integer, SearchSpace
from repro_torch.core.suggest import BOConfig, BOSuggester, EngineCache
from repro_torch.core.warm_start import WarmStartPool

__all__ = [
    "FactorArena",
    "GPHPSamplePool",
    "JobHandle",
    "PoolConflictError",
    "SelectionService",
    "ServiceConfig",
    "SnapshotError",
    "SnapshotVersionError",
    "space_signature",
]


class SnapshotError(ValueError):
    """An engine snapshot cannot be produced or adopted."""


class SnapshotVersionError(SnapshotError):
    """Snapshot schema version differs from this process's
    ``ENGINE_SNAPSHOT_VERSION`` — the replica refuses rather than guessing at
    a schema it cannot reproduce bit-exactly."""


class PoolConflictError(SnapshotError):
    """The restoring service already holds GPHP pool draws for this space
    group that disagree (version or content fingerprint) with the snapshot's.
    Adopting the job anyway would splice it onto draws it has never seen —
    a silent divergence — so the replica refuses (``stale-draws`` on the
    wire) and the client routes to another replica."""


def space_signature(space: SearchSpace) -> Tuple[Any, ...]:
    """Structural identity of a search space: two jobs share decision-engine
    state iff their spaces agree on every parameter (name, type, bounds,
    scaling, choices) — which implies identical encoded dim and warpable
    dims, the two things the GP layer actually consumes."""
    parts: List[Tuple[Any, ...]] = []
    for p in space.parameters:
        if isinstance(p, Categorical):
            parts.append(("cat", p.name, tuple(repr(c) for c in p.choices)))
        else:
            kind = "int" if isinstance(p, Integer) else "float"
            parts.append((kind, p.name, float(p.low), float(p.high), p.scaling))
    return (space.encoded_dim, tuple(parts))


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Knobs of the multi-job service.

    * ``arena_budget_mb`` — total resident Cholesky/L⁻¹ memory across all
      jobs; least-recently-deciding jobs get their factors dropped first.
    * ``share_gphp`` — sibling GPHP-draw adoption (see module docstring).
      False keeps each job's chain bit-identical to a standalone engine.
    * ``sibling_warm_start`` — fold completed sibling observations into a
      newly registered job's GP dataset (per-task z-scored, §5.3).
    * ``min_sibling_obs`` — a sibling contributes only once it has this many
      finished observations (z-scoring needs ≥ 2 to be meaningful).
    * ``default_bo_config`` — engine config for jobs registered without a
      suggester (e.g. ``Tuner(..., suggester=None, service=svc)``).
    """

    arena_budget_mb: float = 256.0
    share_gphp: bool = True
    sibling_warm_start: bool = True
    min_sibling_obs: int = 2
    default_bo_config: Optional[BOConfig] = None


class GPHPSamplePool:
    """Latest packed GPHP draws + slice-chain state for one space group.

    ``version`` increments on every publish; an engine adopts iff the pool is
    ahead of its last sync (``EngineCache.pool_version``), so the job that
    just published never re-adopts its own draws.
    """

    def __init__(self) -> None:
        self.samples: Optional[np.ndarray] = None  # packed (S, 3d+2)
        self.chain_state: Optional[np.ndarray] = None
        self.version = 0
        # stats: decisions = posterior builds served against this pool,
        # publishes = MCMC fits actually run, adoptions = fits avoided.
        self.decisions = 0
        self.publishes = 0
        self.adoptions = 0

    def publish(self, samples: np.ndarray, chain_state: Optional[np.ndarray]) -> None:
        self.samples = np.array(samples)
        if chain_state is not None:
            self.chain_state = np.array(chain_state)
        self.version += 1
        self.publishes += 1

    @property
    def hit_rate(self) -> float:
        """Fraction of posterior builds served without running MCMC."""
        if self.decisions == 0:
            return 0.0
        return 1.0 - self.publishes / self.decisions

    def stats(self) -> Dict[str, Any]:
        """Pool counters as a JSON-safe dict (see attribute comments)."""
        return {
            "version": self.version,
            "decisions": self.decisions,
            "publishes": self.publishes,
            "adoptions": self.adoptions,
            "hit_rate": self.hit_rate,
        }

    # ----------------------------------------------------------- wire image
    def snapshot(self) -> Dict[str, Any]:
        """Exact wire image of the pool: draws + chain state + version, plus
        a content ``fingerprint`` of the draws. Version numbers are
        per-replica counters, so the fingerprint — not the version alone — is
        what lets an adopting replica decide whether its resident pool *is*
        these draws (keep) or conflicts with them (refuse). Replica-local
        stats counters are deliberately not shipped."""
        from repro_torch.core.gp.serialize import array_fingerprint, array_to_wire

        return {
            "version": self.version,
            "samples": array_to_wire(self.samples),
            "chain_state": array_to_wire(self.chain_state),
            "fingerprint": array_fingerprint(self.samples),
        }

    def load_snapshot(self, snap: Dict[str, Any]) -> None:
        """Install ``snapshot()`` output (draws, chain state, version)."""
        from repro_torch.core.gp.serialize import array_from_wire

        self.samples = array_from_wire(snap["samples"])
        self.chain_state = array_from_wire(snap["chain_state"])
        self.version = int(snap["version"])


class FactorArena:
    """LRU bound on the total resident decision-engine memory.

    Each ``EngineCache`` registers here on every decision (``touch``). The
    budget is *end-to-end*: it counts the factor blocks (L, L⁻¹, alpha —
    objective, per-head posteriors, and the cached multi-head alpha block)
    **plus** every tracked job's observation-store bytes (row buffers and
    pending snapshot buffers). Only the factor blocks are evictable — stores
    are live state, so they form the budget's un-evictable floor; when the
    total exceeds the budget, least-recently-used caches are asked to
    ``drop_factors`` — the cached GPHP draws survive, so the evicted job's
    next decision refactorizes (O(S·n³), RNG-free) instead of re-running
    MCMC, and its suggestions are unchanged.
    """

    def __init__(self, budget_bytes: int = 256 << 20):
        self.budget_bytes = int(budget_bytes)
        self._entries: "OrderedDict[Any, EngineCache]" = OrderedDict()
        self.evictions = 0

    def touch(self, key: Any, cache: EngineCache) -> None:
        self._entries.pop(key, None)
        self._entries[key] = cache
        self._enforce(protect=key)

    def remove(self, key: Any) -> None:
        self._entries.pop(key, None)

    def factor_bytes(self) -> int:
        """Evictable bytes: every tracked job's resident factor blocks."""
        return sum(c.factor_nbytes() for c in self._entries.values())

    def store_bytes(self) -> int:
        """Un-evictable bytes: every tracked job's observation store (row
        buffers + pending snapshot buffers)."""
        return sum(c.store_nbytes() for c in self._entries.values())

    def resident_bytes(self) -> int:
        """End-to-end resident bytes: factors + stores."""
        return self.factor_bytes() + self.store_bytes()

    def _enforce(self, protect: Any) -> None:
        # evict LRU-first until under budget; never evict the cache that was
        # just touched (the job currently deciding). Only factor blocks can
        # be dropped: once every unprotected cache is factor-free, the
        # remaining residency is the stores' floor and enforcement stops.
        while self.resident_bytes() > self.budget_bytes:
            victim = None
            for key in self._entries:  # iteration order: LRU → MRU
                if key != protect and self._entries[key].factor_nbytes() > 0:
                    victim = key
                    break
            if victim is None:
                return
            cache = self._entries.pop(victim)
            cache.drop_factors()
            self.evictions += 1
            telemetry.count("arena.evictions")

    def stats(self) -> Dict[str, Any]:
        return {
            "budget_bytes": self.budget_bytes,
            "resident_bytes": self.resident_bytes(),
            "factor_bytes": self.factor_bytes(),
            "store_bytes": self.store_bytes(),
            "tracked_jobs": len(self._entries),
            "evictions": self.evictions,
        }


class _SpaceGroup:
    """All jobs registered on one search-space signature."""

    def __init__(self, space: SearchSpace):
        self.space = space
        self.pool = GPHPSamplePool()
        self.jobs: List[str] = []


class JobHandle:
    """A registered job's view of the service: its store, its suggester, and
    the ``suggest_batch`` entry point — the RPC seam. In-process callers hold
    this object directly; in remote mode the same surface is served by
    ``repro_torch.distributed.engine_client.RemoteJobHandle``, which speaks
    ``repro_torch.core.rpc`` to an engine replica hosting the real
    ``JobHandle``.

    Attributes:
        name: the job's registered name (``TuningJobConfig.job_name``).
        space: the job's ``SearchSpace``.
        suggester: the decision engine serving this job (usually a
            ``BOSuggester`` wired to a service-owned ``EngineCache``).
        store: the job's ``ObservationStore`` (sibling/user warm-start rows
            folded in as parents).
        warm_pool: the combined ``WarmStartPool`` the store's parents came
            from, or None — the Tuner checkpoints this so restore does not
            re-fold siblings' moved histories.
        multi_fidelity: the job's in-service ASHA state
            (``MultiFidelityState``), or None for jobs without it.
        budget_ledger: the job's ``BudgetLedger`` (created when the job was
            registered with ``max_cost`` or a cost-aware engine config), or
            None. The ledger gates *new* suggestion batches only — in-flight
            trials run to completion, bounding overspend by one trial per
            slot (see ``docs/cost_aware.md``).
        stale: set when another registration takes this name; a stale handle
            raises instead of silently serving the new job's engine.
    """

    def __init__(
        self,
        name,
        space,
        suggester,
        store,
        service,
        warm_pool,
        multi_fidelity=None,
        budget_ledger=None,
    ):
        self.name = name
        self.space = space
        self.suggester = suggester
        self.store: ObservationStore = store
        self.service: "SelectionService" = service
        self.warm_pool: Optional[WarmStartPool] = warm_pool
        self.multi_fidelity = multi_fidelity
        self.budget_ledger = budget_ledger
        self.stale = False  # set when another registration takes this name

    def suggest_batch(self, k: int) -> List[Dict[str, Any]]:
        """Serve ``k`` candidate configs (decoded dicts) for this job —
        one batched engine pass. Raises ``RuntimeError`` if the handle went
        stale (its name was re-registered)."""
        if self.stale:
            # another job registered under this name since: routing by name
            # would silently serve decisions from the *new* job's engine.
            raise RuntimeError(
                f"JobHandle {self.name!r} is stale: the name was re-registered"
                " (give concurrent jobs distinct TuningJobConfig.job_name s)"
            )
        if self.budget_ledger is not None:
            # typed refusal: the caller distinguishes "budget spent" from a
            # malformed request and can drain in-flight trials gracefully.
            self.budget_ledger.check(self.name)
        return self.service.suggest_batch(self.name, k)

    def observe_charge(self, cost: float) -> float:
        """Charge a finished trial's cost (backend-clock seconds, or the
        user's cost unit) against the job's budget ledger. Returns the total
        spent so far. No-op for jobs without a ledger."""
        if self.budget_ledger is None:
            return 0.0
        return self.budget_ledger.charge(cost)

    def observe(self, config, y: float) -> bool:
        """Record a finished observation (direct-drive API; the Tuner pushes
        through its own store reference instead)."""
        return self.store.push(config, y)

    def observe_metrics(self, config, values) -> bool:
        """Record a finished observation of a multi-metric job from its
        named metric dict (direct-drive API)."""
        return self.store.push_metrics(config, values)

    def report_rung(self, key, iteration: int, value: float) -> str:
        """Report a running trial's rung crossing (value already signed into
        the minimize convention) and return the in-service ASHA decision:
        ``"stop"`` or ``"continue"``. Jobs without multi-fidelity always
        continue — the client-side stopping rules own that path."""
        if self.stale:
            raise RuntimeError(
                f"JobHandle {self.name!r} is stale: the name was re-registered"
            )
        if self.multi_fidelity is None:
            return "continue"
        decision, _ = self.multi_fidelity.report_rung(key, iteration, value)
        return decision

    def promotion(self) -> Optional[Dict[str, Any]]:
        """Read-only JSON-safe view of the rung tables + memoized decisions
        (None for jobs without multi-fidelity)."""
        if self.multi_fidelity is None:
            return None
        return self.multi_fidelity.promotion()


class SelectionService:
    """Multiplexes N concurrent tuning jobs over shared decision-engine
    state (GPHP pools, a factor arena, sibling warm-start). See the module
    docstring for the sharing semantics. ``device`` is where the suggesters
    the service creates run (``None``: the CUDA card)."""

    def __init__(self, config: ServiceConfig = ServiceConfig(), device=None):
        self.config = config
        self.device = device
        self.arena = FactorArena(int(config.arena_budget_mb * (1 << 20)))
        self._groups: Dict[Tuple[Any, ...], _SpaceGroup] = {}
        self._jobs: Dict[str, JobHandle] = {}

    # ------------------------------------------------------------- registry
    @property
    def num_jobs(self) -> int:
        return len(self._jobs)

    def job(self, name: str) -> JobHandle:
        return self._jobs[name]

    def group_pool(self, name: str) -> GPHPSamplePool:
        """The GPHP pool of the space group ``name`` belongs to."""
        sig = space_signature(self._jobs[name].space)
        return self._groups[sig].pool

    def register_job(
        self,
        name: str,
        space: SearchSpace,
        *,
        suggester=None,
        bo_config: Optional[BOConfig] = None,
        seed: int = 0,
        warm_start: Optional[WarmStartPool] = None,
        fold_siblings: bool = True,
        metrics=None,
        multi_fidelity=None,
        max_cost: Optional[float] = None,
    ) -> JobHandle:
        """Register (or re-register, e.g. after a checkpoint restore) a
        tuning job. Creates the job's observation store (sibling + user
        warm-start folded in), wires a service-owned ``EngineCache`` into the
        suggester (creating a ``BOSuggester`` if none is given), and returns
        the handle decisions are served through.

        ``fold_siblings=False`` skips the automatic sibling fold — used on
        restore, where the checkpointed warm-start pool already contains the
        sibling parents captured at original registration.

        ``metrics`` (a ``repro_torch.core.multimetric.MetricSet``) declares a
        multi-metric job. M > 1 jobs take no warm-start parents (parents
        carry objective values only — there is nothing to fold into the
        constraint heads), but their *objective* column still feeds sibling
        warm-start of single-metric jobs in the group.

        ``multi_fidelity`` (an ``ASHAConfig``, or its wire dict) turns on
        in-service ASHA promotion + the per-rung f(x, r) acquisition heads
        for this job; rung crossings then arrive via
        ``JobHandle.report_rung``. Single-metric jobs only.

        ``max_cost`` caps the job's cumulative trial cost: a ``BudgetLedger``
        is created, charged via ``JobHandle.observe_charge``, and once
        exhausted ``suggest_batch`` raises ``BudgetExhaustedError`` (typed,
        so the wire layer can refuse with ``budget-exhausted``). A ledger is
        also created (uncapped) for cost-aware engine configs, which need it
        for cost-cooling.
        """
        sig = space_signature(space)
        group = self._groups.get(sig)
        if group is None:
            group = self._groups[sig] = _SpaceGroup(space)
        if name in self._jobs:  # re-registration replaces the old entry
            self._unregister(name)

        multi = metrics is not None and metrics.num_metrics > 1
        mf_state = None
        if multi_fidelity is not None:
            if multi:
                raise ValueError(
                    "multi_fidelity supports single-metric jobs only"
                )
            from repro_torch.core.multifidelity import MultiFidelityState

            if isinstance(multi_fidelity, MultiFidelityState):
                mf_state = multi_fidelity
            else:
                cfg = multi_fidelity
                if isinstance(cfg, dict):
                    cfg = MultiFidelityState.config_from_wire(cfg)
                mf_state = MultiFidelityState(cfg)
        if multi and warm_start is not None and warm_start.num_parents > 0:
            raise ValueError(
                "multi-metric jobs cannot take warm-start parents (parent "
                "histories carry objective values only)"
            )
        pools: List[Optional[WarmStartPool]] = [warm_start]
        if fold_siblings and self.config.sibling_warm_start and not multi:
            sib = WarmStartPool()
            for sibling_name in group.jobs:
                pairs = self._jobs[sibling_name].store.own_pairs()
                if len(pairs) >= self.config.min_sibling_obs:
                    sib.add_parent(pairs, name=f"sibling:{sibling_name}")
            pools.append(sib)
        combined = WarmStartPool.merged(*[p for p in pools if p is not None])
        warm_pool = combined if combined.num_parents > 0 else None
        if multi:
            warm_pool = None

        store = ObservationStore(space, warm_start=warm_pool, metrics=metrics)
        cache = EngineCache(
            pool=group.pool if self.config.share_gphp else None,
            arena=self.arena,
            arena_key=name,
        )
        if suggester is None:
            suggester = BOSuggester(
                space,
                bo_config or self.config.default_bo_config or BOConfig(),
                seed=seed,
                store=store,
                cache=cache,
                device=self.device,
            )
        else:
            if hasattr(suggester, "attach_cache"):
                suggester.attach_cache(cache)
            if hasattr(suggester, "bind_store"):
                suggester.bind_store(store)
        # the engine branches to the rung-aware acquisition when this is set
        # and rung tables hold data; unset/None keeps suggestions bit-identical.
        if mf_state is not None:
            suggester.multi_fidelity_state = mf_state

        # budget ledger: created for capped jobs, and for cost-aware engines
        # (whose cost-cooling schedule reads ledger.spent). None keeps the
        # decision stream bit-identical to a budget-free engine.
        ledger = None
        cost_aware = bool(
            getattr(getattr(suggester, "config", None), "cost_aware", False)
        )
        if max_cost is not None or cost_aware:
            from repro_torch.core.budget import BudgetLedger

            ledger = BudgetLedger(max_cost)
            if hasattr(suggester, "budget_ledger"):
                suggester.budget_ledger = ledger

        handle = JobHandle(
            name,
            space,
            suggester,
            store,
            self,
            warm_pool,
            multi_fidelity=mf_state,
            budget_ledger=ledger,
        )
        group.jobs.append(name)
        self._jobs[name] = handle
        return handle

    def _unregister(self, name: str) -> None:
        handle = self._jobs.pop(name)
        handle.stale = True  # loud failure for anyone still holding it
        sig = space_signature(handle.space)
        group = self._groups.get(sig)
        if group is not None and name in group.jobs:
            group.jobs.remove(name)
        self.arena.remove(name)

    # ------------------------------------------------------------ decisions
    def suggest_batch(self, name: str, k: int) -> List[Dict[str, Any]]:
        """Serve k candidates for ``name`` — the multiplexed decision entry
        point (arena LRU accounting happens inside the engine's decision)."""
        handle = self._jobs[name]
        # observation only: engine counters are read *before/after* the
        # decision, never fed back into it (telemetry-oneway invariant).
        pool = getattr(getattr(handle.suggester, "cache", None), "pool", None)
        fits_before = pool.publishes if pool is not None else 0
        with telemetry.span("service.suggest_batch", job=name, k=k):
            out = handle.suggester.suggest_batch(k)
        if telemetry.enabled():
            if pool is not None:
                telemetry.count(
                    "service.pool.miss"
                    if pool.publishes > fits_before
                    else "service.pool.hit"
                )
            telemetry.gauge("arena.resident_bytes", self.arena.resident_bytes())
            telemetry.gauge("arena.factor_bytes", self.arena.factor_bytes())
            telemetry.gauge("arena.evictions_total", self.arena.evictions)
            if handle.budget_ledger is not None:
                telemetry.gauge(
                    f"budget.spent.{name}", handle.budget_ledger.spent
                )
        return out

    # ------------------------------------------------------------ snapshots
    def snapshot_job(self, name: str, include_factors: bool = False) -> Dict[str, Any]:
        """Produce the complete, versioned, JSON-safe wire image of one job's
        engine state — everything a fresh process needs to continue the job's
        suggestion stream *bit-exactly*: search space spec, engine config,
        construction seed, warm pool, observation store (parents + own rows +
        pending set), suggester RNG/cadence state, the cached GPHP draws, and
        the group pool (draws + chain + version + content fingerprint).

        ``include_factors=True`` additionally ships the O(S·n²) posterior
        factor blocks; by default the adopting replica rehydrates them
        locally (RNG-free, suggestion-invariant — the same rebuild arena
        eviction exercises).

        Raises ``SnapshotError`` for suggesters that are not snapshot-capable
        (anything without the ``BOSuggester`` state surface).
        """
        from repro_torch.core.rpc import ENGINE_SNAPSHOT_VERSION, bo_config_to_wire

        handle = self._jobs[name]
        sugg = handle.suggester
        for attr in ("state_dict", "cache", "config", "seed"):
            if not hasattr(sugg, attr):
                raise SnapshotError(
                    f"suggester {type(sugg).__name__} lacks {attr!r}; engine "
                    "snapshots require the BOSuggester state surface"
                )
        cache = sugg.cache
        metrics = getattr(handle.store, "metrics", None)
        return {
            "snapshot_version": ENGINE_SNAPSHOT_VERSION,
            "job_name": name,
            "space": handle.space.to_spec(),
            "bo_config": bo_config_to_wire(sugg.config),
            "seed": sugg.seed,
            "metrics": None if metrics is None else metrics.to_wire(),
            "service": {
                "share_gphp": self.config.share_gphp,
                "sibling_warm_start": self.config.sibling_warm_start,
            },
            "warm_pool": None
            if handle.warm_pool is None
            else handle.warm_pool.state_dict(),
            "store": handle.store.snapshot(),
            "suggester": sugg.state_dict(),
            "cache": cache.snapshot(include_factors=include_factors),
            "pool": None if cache.pool is None else cache.pool.snapshot(),
            "multi_fidelity": None
            if handle.multi_fidelity is None
            else handle.multi_fidelity.snapshot(),
        }

    def restore_job(self, snap: Dict[str, Any]) -> JobHandle:
        """Adopt a ``snapshot_job`` image into this service (typically a
        different process) and return the live handle. The restored job's
        next-k suggestions are bit-identical to what the snapshotted engine
        would have produced.

        Refusals (checked before any state is mutated):
          * ``SnapshotVersionError`` — snapshot schema this process does not
            speak (``ENGINE_SNAPSHOT_VERSION`` mismatch);
          * ``PoolConflictError`` — this service already holds GPHP draws for
            the job's space group that disagree with the snapshot's pool
            (version or fingerprint): splicing the job onto draws it has
            never seen would diverge silently, so the caller must pick
            another replica instead.

        Replicas are expected to run the same ``ServiceConfig`` (the snapshot
        records ``share_gphp``/``sibling_warm_start`` for debuggability, but
        mixed fleets are a deployment error, not a guarded path).
        """
        from repro_torch.core.gp.serialize import array_fingerprint
        from repro_torch.core.rpc import ENGINE_SNAPSHOT_VERSION, bo_config_from_wire

        version = snap.get("snapshot_version")
        if version != ENGINE_SNAPSHOT_VERSION:
            raise SnapshotVersionError(
                f"snapshot schema v{version}, this process speaks "
                f"v{ENGINE_SNAPSHOT_VERSION}"
            )
        space = SearchSpace.from_spec(snap["space"])
        pool_snap = snap.get("pool")
        # a snapshot with no pool draws (taken before the job's first refit)
        # has nothing to conflict with — resident sibling draws are then no
        # more foreign than they would be to a freshly registered job.
        if (
            pool_snap is not None
            and pool_snap.get("samples") is not None
            and self.config.share_gphp
        ):
            group = self._groups.get(space_signature(space))
            if group is not None and group.pool.samples is not None:
                same = (
                    group.pool.version == pool_snap["version"]
                    and array_fingerprint(group.pool.samples)
                    == pool_snap["fingerprint"]
                )
                if not same:
                    raise PoolConflictError(
                        "resident GPHP pool (version "
                        f"{group.pool.version}) conflicts with snapshot pool "
                        f"(version {pool_snap['version']})"
                    )
        warm_pool = None
        if snap.get("warm_pool"):
            warm_pool = WarmStartPool()
            warm_pool.load_state_dict(snap["warm_pool"])
        from repro_torch.core.multimetric import MetricSet

        mf_snap = snap.get("multi_fidelity")
        # budget state rides the suggester snapshot; re-create the ledger
        # with the recorded cap so load_state_dict can restore `spent`.
        bud_snap = snap["suggester"].get("budget")
        handle = self.register_job(
            snap["job_name"],
            space,
            bo_config=bo_config_from_wire(snap["bo_config"]),
            seed=int(snap["seed"]),
            warm_start=warm_pool,
            fold_siblings=False,  # the snapshot's parent rows are authoritative
            metrics=MetricSet.from_wire(snap.get("metrics")),
            multi_fidelity=None if mf_snap is None else mf_snap["config"],
            max_cost=None if bud_snap is None else bud_snap.get("max_cost"),
        )
        if mf_snap is not None:
            handle.multi_fidelity.load_snapshot(mf_snap)
        handle.store.load_snapshot(snap["store"])
        handle.suggester.load_state_dict(snap["suggester"])
        cache = handle.suggester.cache
        cache.load_snapshot(
            snap["cache"], device=getattr(handle.suggester, "device", None)
        )
        if cache.pool is not None and pool_snap is not None:
            if cache.pool.samples is None and pool_snap["samples"] is not None:
                cache.pool.load_snapshot(pool_snap)
        return handle

    # -------------------------------------------------------------- insight
    def stats(self) -> Dict[str, Any]:
        groups = []
        for sig, group in self._groups.items():
            groups.append(
                {
                    "encoded_dim": sig[0],
                    "jobs": list(group.jobs),
                    "pool": group.pool.stats(),
                }
            )
        return {"arena": self.arena.stats(), "groups": groups}
