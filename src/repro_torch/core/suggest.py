"""Candidate suggestion: the incremental BO decision engine of AMT (paper §4).

The engine is *stateful*: it reads observations from an ``ObservationStore``
(``repro_torch.core.history``) and keeps two caches between decisions so the
per-decision cost is amortized:

  * **GPHP samples** — slice-sampling (paper default, §4.2) is the dominant
    cost. ``BOConfig.refit_every`` re-samples only after that many *new*
    observations; between refits the cached draws are reused and only the
    posterior factors change.
  * **Cholesky factors** — one ``GPPosterior`` per GPHP sample is cached on
    the engine's device. A new observation is folded in by a rank-1 border
    append (``repro_torch.core.gp.incremental``, O(S·n²)) instead of
    refactorizing at O(S·n³); ``alpha`` is recomputed each decision because
    the running standardization rescales every target.

One decision step (``suggest_batch``):

  1. Read the store's standardized snapshot (encoded X, zero-mean/unit-std y
     — paper §4.2); cold-start from a Sobol design below ``num_init`` (§2.1).
  2. Bring the cached posterior up to date (refit / rank-1 appends).
  3. Handle pending candidates (§4.4): "exclude" (paper-faithful — never
     re-propose), or fantasize them onto a scratch posterior via the same
     rank-1 append ("liar" / "kb", beyond-paper).
  4. For each of the k freed slots: optimize integrated EI over Sobol anchors
     + gradient refinement (§4.3), round-trip the winner through the search
     space, de-duplicate, then fantasize the interim pick so the remaining
     slots are filled from one pipeline pass instead of k full pipelines.

Multi-metric jobs (a ``MetricSet`` with M > 1 on the store: constrained EI
or Pareto random-scalarization EI), cost-aware jobs (``BOConfig.cost_aware``:
EI per unit cost on a log-cost head) and multi-fidelity jobs whose rung
tables hold data (``multi_fidelity_state``: rung-weighted EI over per-rung
heads) branch off after the shared cold start. Their extra heads ride the
objective's cached factor — one batched solve for the M head alphas per
decision — and anchors are scored by the fused ``acq_score_multi`` kernel.

Both caches live in an ``EngineCache`` the suggester owns by default; in
service mode (``repro_torch.core.service``) the ``SelectionService`` owns it
instead: sibling jobs on the same search space adopt each other's GPHP
draws through a shared pool, and a factor arena bounds the total resident
factor memory across jobs (eviction drops factors only; rebuilds replay the
factorization RNG-free, so suggestions are invariant under eviction).

The store's rows stay numpy on the host and become float64 tensors on the
engine's device at the GP boundary. The device is the suggester's
(``device=None`` means the CUDA card; the CPU only when asked for). Random
draws follow the JAX package's threefry key stream (``core/prng.py``), so
the engine makes the reference's decisions and loads its ``state_dict``.

Large stores (``BOConfig.posterior_backend="subset"``): once a refit
boundary reaches ``n_switch`` rows, the factor covers only the
``max_inducing`` rows that ``core/gp/sparse.py::select_inducing`` picks
over the store prefix (plus the rows appended since), so the factor stays
O(S·m²) however long the store grows. Factor row i is then
``EngineCache.live_rows(n)[i]``, not store row i: targets, appends and the
pending set's cross rows all go through the live rows. Multi-metric jobs
may give every extra head its own GPHP chain and factor
(``BOConfig.per_head_gphp``); their scores then go through the torch
composition, per-head variances being outside the fused kernel's layout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import prng, telemetry
from repro_torch.core.device import resolve_device
from repro_torch.core.gp import gp as gplib
from repro_torch.core.gp import kernels as gpkernels
from repro_torch.core.gp import params as gpparams
from repro_torch.core.gp.empirical_bayes import EmpiricalBayesConfig
from repro_torch.core.gp.fit import check_map_backend, map_gphps, mcmc_gphps
from repro_torch.core.gp.per_resource import (
    rung_head_targets,
    rung_head_weights,
)
from repro_torch.core.gp.multi import (
    MultiOutputPosterior,
    predict_heads,
    solve_head_alphas,
)
from repro_torch.core.gp.incremental import (
    grow_posterior,
    posterior_append,
    posterior_append_block,
    posterior_delete,
    refresh_alpha,
)
from repro_torch.core.gp.slice_sampler import (
    FAST_CONFIG,
    PAPER_CONFIG,
    SliceSamplerConfig,
)
from repro_torch.core.gp.sparse import select_inducing
from repro_torch.core.history import ObservationStore, bucket_size
from repro_torch.core.optimize_acq import (
    AcqOptConfig,
    MultiMetricHead,
    optimize_acquisition,
    optimize_acquisition_multi,
)
from repro_torch.core.search_space import SearchSpace
from repro_torch.core.sobol import SobolSequence

__all__ = [
    "BOConfig",
    "BOSuggester",
    "EngineCache",
    "RandomSuggester",
    "SobolSuggester",
]

Observation = Tuple[Mapping[str, Any], float]


@dataclasses.dataclass(frozen=True)
class BOConfig:
    """Configuration of the BO engine. Defaults are the paper's choices.

    Two backend knobs, deliberately independent:

    * ``backend`` — anchor-*scoring* backend, a convenience that overrides
      ``acq.backend``. ``"kernel"`` (the default of ``AcqOptConfig``) fuses
      cross-gram + cached-inverse solve + EI/LCB into one kernel pass
      (``repro_torch.kernels.acq_score``); ``"torch"`` is the composition.
    * ``fit_backend`` — gram backend for GPHP fitting and factorization
      (MCMC marginal-likelihood grams, refits, rank-1 appends). ``"torch"``
      by default: the ``"kernel"`` gram is float32 (as the TPU kernel it
      replaces) and would perturb the float64 chain. Kept separate so
      switching the scoring backend never perturbs the fitted posterior.
      MAP-II fitting (``gphp_method="map"``) differentiates the gram, so it
      takes ``"torch"`` only.
    """

    num_init: int = 3  # Sobol initial design before the GP takes over
    gphp_method: str = "mcmc"  # "mcmc" (slice sampling) | "map" (empirical Bayes)
    slice_config: SliceSamplerConfig = PAPER_CONFIG
    eb_config: EmpiricalBayesConfig = EmpiricalBayesConfig()
    acq: AcqOptConfig = AcqOptConfig()
    pending_strategy: str = "exclude"  # "exclude" | "liar" | "kb" (beyond-paper)
    liar_value: float = 0.0  # standardized-space constant liar (0 = mean liar)
    dedupe_tol: float = 1e-6  # L∞ tolerance for duplicate candidates
    max_pending: int = 64  # static pad size for the pending buffer
    refit_every: int = 1  # re-sample GPHPs after this many new observations
    incremental: bool = True  # rank-1 posterior updates between refits
    backend: Optional[str] = None  # constructor shorthand: folded into
    # acq.backend and reset to None
    fit_backend: str = "torch"  # gram backend for GPHP fitting/factorization
    num_scalarizations: int = 16  # Pareto mode: simplex weight draws/decision
    fantasy_block: bool = False  # fold the pending set with one rank-k
    # blocked append instead of k rank-1 borders ("liar" strategy only)
    posterior_backend: str = "exact"  # "exact" | "subset" (inducing rows,
    # core/gp/sparse.py) — "subset" caps the factor at max_inducing rows
    # once the refit boundary reaches n_switch; below that it is the exact
    # backend bit for bit
    n_switch: int = 2048  # store rows at a refit boundary before "subset"
    # actually switches away from the exact factorization
    max_inducing: int = 1024  # inducing rows selected at each refit boundary
    per_head_gphp: bool = False  # M>1 jobs: give every constraint/latency
    # head its own GPHP chain (and factor) instead of sharing the objective's
    # draws; default off — the shared-factor layout
    cost_aware: bool = False  # EI-per-unit-cost: a log-cost head rides the
    # shared factor and EI is discounted by exp(-eta * zc(x)); off (the
    # default) is the cost-blind engine
    cost_cooling: float = 1.0  # eta scale for the cost discount; with a
    # capped budget ledger attached the effective eta decays linearly with
    # spend, so the cheap-first bias fades as the job closes on its budget

    def __post_init__(self):
        if self.backend is not None:
            if self.backend != self.acq.backend:
                object.__setattr__(
                    self, "acq", self.acq._replace(backend=self.backend)
                )
            object.__setattr__(self, "backend", None)
        if self.acq.backend not in ("kernel", "torch"):
            raise ValueError(
                f"unknown scoring backend {self.acq.backend!r} "
                "(expected 'kernel' or 'torch')"
            )
        if self.fit_backend not in ("kernel", "torch"):
            raise ValueError(f"unknown fit_backend {self.fit_backend!r}")
        if self.gphp_method == "map":
            check_map_backend(self.fit_backend)
        if self.posterior_backend not in ("exact", "subset"):
            raise ValueError(
                f"unknown posterior_backend {self.posterior_backend!r} "
                "(expected 'exact' or 'subset')"
            )
        if self.max_inducing < 2:
            raise ValueError("max_inducing must be at least 2")
        if self.cost_cooling < 0:
            raise ValueError("cost_cooling must be non-negative")

    def fast(self) -> "BOConfig":
        """Cheaper MCMC settings for many-seed benchmark sweeps."""
        return dataclasses.replace(self, slice_config=FAST_CONFIG)


class EngineCache:
    """The extractable cache block of the incremental BO engine.

    Holds everything a decision reuses between calls: the packed GPHP draws,
    the factorized ``GPPosterior`` covering the store prefix ``[0, n)``, and
    the refit-cadence accounting. A standalone ``BOSuggester`` owns a private
    instance; a ``SelectionService`` (``repro_torch.core.service``) instead
    hands out instances wired to a shared **GPHP sample pool** (sibling jobs
    on the same search space adopt each other's draws instead of re-running
    the chain) and registered in a **factor arena** (an LRU bound on total
    resident factor memory — eviction calls ``drop_factors``, which is always
    safe: the factorization rebuilds from ``samples`` without consuming any
    RNG state, so suggestions are invariant under eviction).
    """

    def __init__(self, pool=None, arena=None, arena_key=None):
        self.samples: Optional[np.ndarray] = None  # packed (S, 3d+2) draws
        self.post = None  # GPPosterior for the live rows
        self.n = 0  # observations folded into the cadence accounting
        self.obs_since_refit = 0
        self.token: Optional[int] = None  # id() of the store the cache maps
        self.pool = pool  # GPHPSamplePool shared by sibling jobs (or None)
        self.pool_version = -1  # pool.version last adopted/published
        self.arena = arena  # FactorArena bounding factor residency (or None)
        self.arena_key = arena_key
        self.store = None  # last bound ObservationStore (arena accounting)
        # --- subset posterior backend (core/gp/sparse.py) -----------------
        # store-row indices of the inducing set selected at the last refit
        # boundary, or None when the exact backend is live. inducing_n0 is
        # the store-row count at selection time: rows [inducing_n0, n) were
        # appended to the factor after the boundary.
        self.inducing_sel: Optional[np.ndarray] = None
        self.inducing_n0 = 0
        # --- per-head GPHP chains (BOConfig.per_head_gphp) ----------------
        self.head_samples: Optional[List[np.ndarray]] = None  # per extra head
        self.head_posts: Optional[list] = None  # per-head GPPosteriors
        self.head_n = 0  # store rows folded into the head factors
        self.head_alphas = None  # last shared-factor head alphas (accounting)

    # ------------------------------------------------------------ live rows
    def live_rows(self, n: int) -> np.ndarray:
        """Store-row indices the resident factor covers, in factor order:
        all of ``[0, n)`` on the exact backend, else the inducing set plus
        every row appended since the boundary."""
        if self.inducing_sel is None:
            return np.arange(n, dtype=np.int64)
        return np.concatenate(
            [self.inducing_sel, np.arange(self.inducing_n0, n, dtype=np.int64)]
        )

    # ------------------------------------------------------------ lifecycle
    def reset(self) -> None:
        self.samples = None
        self.post = None
        self.n = 0
        self.obs_since_refit = 0
        self.token = None
        self.pool_version = -1
        self.inducing_sel = None
        self.inducing_n0 = 0
        self.head_samples = None
        self.head_posts = None
        self.head_n = 0
        self.head_alphas = None

    def invalidate_factors(self) -> None:
        """Forget the factorization but keep draws + cadence (store rebind)."""
        self.post = None
        self.token = None
        self.inducing_sel = None
        self.inducing_n0 = 0
        self.head_posts = None
        self.head_alphas = None

    def drop_factors(self) -> None:
        """Arena eviction hook: release the O(S·n²) factor blocks (objective
        and per-head) plus the cached head alphas. The next decision rebuilds
        them from ``samples``/``head_samples`` (RNG-free, deterministic) —
        including the inducing-set selection, which is a pure function of the
        store prefix at the boundary."""
        self.post = None
        self.inducing_sel = None
        self.inducing_n0 = 0
        self.head_posts = None
        self.head_alphas = None

    def factor_nbytes(self) -> int:
        """Resident bytes of the factor blocks (what the arena budgets): the
        objective posterior's tensors (x, mask, L, alpha, the GPHPs, L⁻¹ when
        cached), any per-head posteriors and the cached multi-head alpha
        block — the reference's leaves, so both packages evict in the same
        order."""
        total = 0
        stack = [self.post, self.head_alphas, *(self.head_posts or ())]
        while stack:
            block = stack.pop()
            if isinstance(block, torch.Tensor):
                total += block.numel() * block.element_size()
            elif isinstance(block, tuple):  # GPPosterior, GPHyperParams
                stack.extend(block)
        return total

    def store_nbytes(self) -> int:
        """Resident bytes of the bound observation store (rows + pending
        buffers) — the un-evictable floor of the arena's end-to-end budget."""
        if self.store is None or not hasattr(self.store, "nbytes"):
            return 0
        return int(self.store.nbytes())

    def touched(self) -> None:
        """Mark this cache most-recently-used in its arena (if any)."""
        if self.arena is not None:
            self.arena.touch(self.arena_key, self)

    # ----------------------------------------------------------- wire image
    def snapshot(self, include_factors: bool = False) -> Dict[str, Any]:
        """Exact wire image of the cache block, in the JAX package's schema
        (versioned by the enclosing engine snapshot — see
        ``SelectionService.snapshot_job``).

        ``include_factors=False`` (default) ships only the GPHP draws and the
        cadence counters: the factor blocks are a deterministic function of
        draws + observation rows, so a restoring service rebuilds them
        locally (the replay arena eviction uses). ``include_factors=True``
        additionally ships the factorized posterior."""
        from repro_torch.core.gp.serialize import array_to_wire, posterior_to_wire

        return {
            "samples": array_to_wire(self.samples),
            "n": self.n,
            "obs_since_refit": self.obs_since_refit,
            "pool_version": self.pool_version,
            "factors": posterior_to_wire(self.post)
            if include_factors and self.post is not None
            else None,
            # subset backend: the inducing set is replayable (select_inducing
            # is deterministic over the store prefix), but shipping it keeps
            # factor-bearing snapshots self-describing
            "inducing_sel": array_to_wire(self.inducing_sel),
            "inducing_n0": self.inducing_n0,
            # per-head GPHP draws (factors rehydrate like the objective's)
            "head_samples": None
            if self.head_samples is None
            else [array_to_wire(s) for s in self.head_samples],
            "head_n": self.head_n,
        }

    def load_snapshot(self, snap: Mapping[str, Any], device=None) -> None:
        """Install ``snapshot()`` output (this package's or the JAX
        package's). Pool/arena wiring is left untouched (those belong to the
        hosting service); factors land on ``device`` if the snapshot shipped
        them, else rebuild lazily on the next decision."""
        from repro_torch.core.gp.serialize import array_from_wire, posterior_from_wire

        self.samples = array_from_wire(snap["samples"])
        self.n = int(snap["n"])
        self.obs_since_refit = int(snap["obs_since_refit"])
        self.pool_version = int(snap["pool_version"])
        factors = snap.get("factors")
        self.post = (
            None if factors is None else posterior_from_wire(factors, device)
        )
        self.token = None  # factors (if any) bind to whatever store comes next
        sel = array_from_wire(snap.get("inducing_sel"))
        self.inducing_sel = None if sel is None else sel.astype(np.int64)
        self.inducing_n0 = int(snap.get("inducing_n0", 0))
        hs = snap.get("head_samples")
        self.head_samples = (
            None if hs is None else [array_from_wire(s) for s in hs]
        )
        self.head_posts = None  # rebuilt lazily, like the objective factors
        self.head_n = int(snap.get("head_n", 0))
        self.head_alphas = None


class BOSuggester:
    """Stateful sequential/asynchronous Bayesian-optimization suggester
    (minimize). Bind an ``ObservationStore`` (``bind_store``) and call
    ``suggest_batch(k)``; or use the stateless ``suggest(history, pending)``
    compatibility API.

    Args:
        space: the ``SearchSpace`` candidates are drawn from.
        config: engine knobs (``BOConfig``; defaults are the paper's).
        seed: drives every random element — numpy RNG, threefry key, and the
            Sobol shift scramble. Two suggesters built with the same
            (space, config, seed) walk identical decision streams, and the
            same seed gives the JAX package's stream.
        store: optional ``ObservationStore`` to bind now (else ``bind_store``).
        cache: optional service-owned ``EngineCache`` (else a private one).
        device: where the GP numerics run. ``None`` is the CUDA card (a
            ``RuntimeError`` if none is visible); tests pass ``"cpu"``.

    ``state_dict()``/``load_state_dict()`` capture everything *drawn since
    construction*; a JAX ``BOSuggester.state_dict()`` loads unchanged.
    Factors are never part of the state: they rebuild by an RNG-free replay
    of the incremental construction (see ``_advance_factors``).
    """

    def __init__(
        self,
        space: SearchSpace,
        config: BOConfig = BOConfig(),
        seed: int = 0,
        store: Optional[ObservationStore] = None,
        cache: Optional[EngineCache] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.space = space
        self.config = config
        self.seed = seed
        self._rng = np.random.default_rng(seed)  # invariant: fresh-rng -- constructor-seeded; the bit-generator state is checkpointed in state_dict and restored on replay
        self._key = prng.PRNGKey(seed)
        self._sobol_init = SobolSequence(space.encoded_dim, shift_rng=np.random.default_rng(seed))  # invariant: fresh-rng -- shift scramble is a pure function of the recorded construction seed; rebuilt identically from the snapshot
        self._anchor_gen = SobolSequence(space.encoded_dim)
        self._anchors = self._tensor(self._anchor_gen.next(config.acq.num_anchors))
        self._bounds = gpparams.default_bounds(
            space.encoded_dim, space.warpable_dims()
        )
        # persisted slice-chain state: warm-starts the next chain
        self._chain_state: Optional[np.ndarray] = None
        # per-head chains (BOConfig.per_head_gphp): slot j warm-starts the
        # chain of extra head j+1
        self._head_chain_states: Dict[int, np.ndarray] = {}
        # did the last _posterior_for re-fit or adopt draws? (the per-head
        # factors re-fit at exactly the objective's boundaries)
        self._boundary_refit = False
        self._store: Optional[ObservationStore] = store
        if store is not None:
            self._check_multimetric_config(store)
        # in-service ASHA state (``repro_torch.core.multifidelity``) — set by
        # the SelectionService when the job declares multi_fidelity. None
        # (the default) keeps every decision on the single-metric path.
        self.multi_fidelity_state = None
        # budget ledger (``repro_torch.core.budget``) — attached by the Tuner
        # or SelectionService when the job declares max_cost or cost_aware.
        # None (the default) leaves the "budget" key out of state_dict.
        self.budget_ledger = None
        self._wrapper_store: Optional[ObservationStore] = None
        self._wrapper_fps: List[Tuple[float, bytes]] = []
        # the cache block is an object of its own so a SelectionService can
        # own it (shared GPHP pool + arena-bounded factors) and hand it out.
        self.cache = cache if cache is not None else EngineCache()

    # ------------------------------------------------------------ helpers
    def _tensor(self, arr, dtype=torch.float64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), dtype=dtype).to(self.device)

    # ------------------------------------------------------------------ rng
    def _next_key(self) -> np.ndarray:
        self._key, sub = prng.split(self._key)
        return sub

    # ----------------------------------------------------------- store glue
    def _check_multimetric_config(self, store: ObservationStore) -> None:
        """Reject config/store combinations the multi-metric and cost-aware
        decision paths cannot serve — at bind time, not after the cold-start
        trials have already spent their budget."""
        ms = getattr(store, "metrics", None)
        if ms is not None and ms.num_metrics > 1 and self.config.acq.acq != "ei":
            raise ValueError(
                "multi-metric jobs support acq='ei' only (constrained EI / "
                f"random-scalarization EI), got {self.config.acq.acq!r}"
            )
        if self.config.cost_aware:
            if ms is not None and ms.num_metrics > 1:
                raise ValueError(
                    "cost_aware jobs are single-metric (the log-cost head "
                    "rides the objective factor; M > 1 stores already spend "
                    "the extra head slots on metrics)"
                )
            if self.config.acq.acq != "ei":
                raise ValueError(
                    "cost_aware jobs support acq='ei' only (EI-per-unit-"
                    f"cost), got {self.config.acq.acq!r}"
                )

    def bind_store(self, store: ObservationStore) -> None:
        """Attach the engine to a live observation store (the Tuner does this
        at construction and after restore). Cached GPHP samples survive a
        rebind; the factorization is rebuilt lazily against the new store."""
        self._check_multimetric_config(store)
        self._store = store
        self.cache.invalidate_factors()

    def attach_cache(self, cache: EngineCache) -> None:
        """Swap in a service-owned cache block (pool/arena wired). Any draws
        already cached privately carry over, so attaching is never a
        regression for a warm engine."""
        if cache.samples is None and self.cache.samples is not None:
            cache.samples = self.cache.samples
            cache.n = self.cache.n
            cache.obs_since_refit = self.cache.obs_since_refit
            cache.token = self.cache.token
        self.cache = cache

    def reset_cache(self) -> None:
        self.cache.reset()

    def _sync_wrapper_store(self, history: Sequence[Observation]) -> ObservationStore:
        """Mirror a caller-owned history list into a private store. Append-only
        callers hit the incremental path; an objective-only rewrite or a
        single deletion stays incremental too (see
        ``_try_incremental_rewrite``); anything else falls back to a fresh
        store + full refit."""
        fps: List[Tuple[float, bytes]] = []
        entries: List[Tuple[np.ndarray, float]] = []
        for cfg_, y in history:
            x = self.space.encode(cfg_)
            entries.append((x, float(y)))
            fps.append((float(y), x.tobytes()))
        fresh = self._wrapper_store is None
        if not fresh and fps[: len(self._wrapper_fps)] == self._wrapper_fps:
            tail = entries[len(self._wrapper_fps):]
        else:
            tail = None if fresh else self._try_incremental_rewrite(fps, entries)
            if tail is None:
                if not fresh:  # unrecognized rewrite: cached state is stale
                    self.reset_cache()
                self._wrapper_store = ObservationStore(self.space)
                tail = entries
        for x, y in tail:
            self._wrapper_store.push_encoded(x, y)
        self._wrapper_fps = fps
        return self._wrapper_store

    def _try_incremental_rewrite(
        self,
        fps: List[Tuple[float, bytes]],
        entries: List[Tuple[np.ndarray, float]],
    ) -> Optional[List[Tuple[np.ndarray, float]]]:
        """Recognize a correction-shaped history rewrite; returns the append
        tail on success, None to fall back to the stateless rebuild."""
        old = self._wrapper_fps
        if any(not math.isfinite(y) for y, _ in old) or any(
            not math.isfinite(y) for y, _ in fps
        ):
            return None
        # --- objective-only rewrite: same inputs, some targets changed ------
        if len(fps) >= len(old) and all(
            fps[i][1] == old[i][1] for i in range(len(old))
        ):
            for i in range(len(old)):
                if fps[i][0] != old[i][0]:
                    self._wrapper_store.rewrite_own_y(i, fps[i][0])
            return entries[len(old):]
        # --- single deletion: old == new with one row removed ---------------
        cache = self.cache
        if (
            len(fps) >= len(old) - 1
            and cache.post is not None
            and cache.token in (None, id(self._wrapper_store))  # invariant: id-key -- within-process factor-cache identity check only; the token is never serialized and a fresh process rebuilds the cache from scratch
            and cache.n == len(old)
            # subset backend: store row i is not factor row i once the
            # inducing set is live, so the rank-1 downdate does not apply —
            # fall back to the stateless rebuild.
            and cache.inducing_sel is None
        ):
            for i in range(len(old)):
                if old[:i] == fps[:i] and old[i + 1 :] == fps[i : len(old) - 1]:
                    self._wrapper_store.delete_own(i)
                    cache.post = posterior_delete(cache.post, i)
                    cache.n -= 1
                    return entries[len(old) - 1 :]
        return None

    # ------------------------------------------------------------- main api
    def suggest(
        self,
        history: Sequence[Observation],
        pending: Sequence[Mapping[str, Any]] = (),
    ) -> Dict[str, Any]:
        """Compatibility wrapper: one decision from an explicit history."""
        store = self._sync_wrapper_store(history)
        pend_np = (
            self.space.encode_batch(list(pending))
            if pending
            else np.zeros((0, self.space.encoded_dim))
        )
        return self._decide(store, 1, pend_np)[0]

    def suggest_batch(self, k: int) -> List[Dict[str, Any]]:
        """Fill k freed slots in one engine pass (batched slot refill)."""
        if self._store is None:
            raise RuntimeError("suggest_batch requires a bound ObservationStore")
        with telemetry.span("suggest.encode"):
            pend_np = self._store.pending_encoded()
        return self._decide(self._store, k, pend_np)

    # ------------------------------------------------------------ decisions
    def _decide(
        self, store: ObservationStore, k: int, pend_np: np.ndarray
    ) -> List[Dict[str, Any]]:
        with telemetry.span(
            "suggest.decide", n=store.num_observations, k=k, pending=len(pend_np)
        ):
            return self._decide_impl(store, k, pend_np)

    def _decide_impl(
        self, store: ObservationStore, k: int, pend_np: np.ndarray
    ) -> List[Dict[str, Any]]:
        cfg = self.config
        n = store.num_observations
        picks: List[np.ndarray] = []
        out: List[Dict[str, Any]] = []

        if n < max(2, cfg.num_init):
            x_seen = store.x_rows(0, n)
            for _ in range(k):
                config, vec = self._quasi_random(
                    self._seen_matrix(x_seen, pend_np, picks)
                )
                picks.append(vec)
                out.append(config)
            return out

        ms = getattr(store, "metrics", None)
        if ms is not None and ms.num_metrics > 1:
            # multi-metric jobs branch off *after* the shared cold start
            return self._decide_multi(store, k, pend_np, ms)

        mf = self.multi_fidelity_state
        if cfg.cost_aware and mf is not None:
            raise ValueError(
                "cost_aware jobs do not support multi_fidelity (the rung "
                "heads already own the extra head slots)"
            )
        if mf is not None and mf.num_active_rungs() > 0:
            # multi-fidelity jobs score (x, r) jointly once rung tables hold
            # data; with empty tables (or multi_fidelity off) the
            # single-metric path below is untouched.
            return self._decide_rungs(store, k, pend_np, mf)
        if cfg.cost_aware:
            costs = store.own_costs()
            n_fin = sum(
                1 for c in costs
                if c is not None and math.isfinite(c) and c > 0.0
            )
            if n_fin >= 2:
                # the cost head needs two finite costs before its z-scoring
                # is meaningful; below that the decision falls through to the
                # cost-blind path (same RNG stream).
                return self._decide_cost(store, k, pend_np, costs)

        x_all, y_std, _, _ = store.standardized()
        post, rows = self._decision_posterior(store, x_all, y_std)
        y_best = float(y_std.min())  # best *real* observation

        def score(work, head, pend_buf, pend_mask, key):
            return optimize_acquisition(
                work, self._anchors, y_best, pend_buf, pend_mask, key, cfg.acq
            )

        return self._refill(k, pend_np, x_all, post, [y_std[rows]], score)

    def _decision_posterior(
        self, store: ObservationStore, x_all: np.ndarray, y_obj: np.ndarray
    ):
        """The decision's objective posterior over the store's n rows, its
        alpha solved for the standardized objective ``y_obj``, and the live
        store rows its factor covers (in factor order)."""
        n = store.num_observations
        with telemetry.span("suggest.posterior", n=n):
            post = self._posterior_for(store, x_all, y_obj)
        rows = self.cache.live_rows(n)
        post = self.cache.post = self._refreshed(post, y_obj[rows])
        return post, rows

    def _refill(
        self, k: int, pend_np: np.ndarray, x_all: np.ndarray, post,
        y_cols, score, heads=None, head_posts=None,
    ) -> List[Dict[str, Any]]:
        """Pending handling (§4.4) and the batched refill every GP decision
        shares: fold the pending trials into a scratch posterior as
        fantasies (constant liar or kriging believer) or exclude them, then
        fill the k slots from one pipeline pass, fantasizing each interim
        pick for the slots after it.

        ``y_cols`` are the heads' live targets, the objective's first.
        ``score(work, head, pend_buf, pend_mask, key)`` ranks one slot's
        candidates. ``heads(work, y_block, head_work)`` re-solves the extra
        heads' scoring state after every fold (None: a single metric).
        ``head_posts`` (per-head layout) are the extra heads' own
        posteriors: fantasies fold into each of them too."""
        cfg = self.config
        fantasize = cfg.pending_strategy in ("liar", "kb")
        work, head_work = post, list(head_posts or ())
        yh_work = [list(col) for col in y_cols]
        n_live = len(yh_work[0])
        head = None
        if heads is not None:
            head = heads(work, self._pad_heads(yh_work, work), head_work)
            # arena accounting (factor_nbytes); the per-head layout has no block
            self.cache.head_alphas = None if head_posts is not None else head.alphas
        pend_buf = np.zeros((cfg.max_pending, self.space.encoded_dim))
        pend_mask = np.zeros(cfg.max_pending, dtype=bool)
        n_excl = 0
        if fantasize and len(pend_np) > 0:
            with telemetry.device_span(
                "suggest.pending_fold", self.device, pending=len(pend_np)
            ):
                if (heads is None and cfg.fantasy_block
                        and cfg.pending_strategy == "liar" and len(pend_np) > 1):
                    work, yh_work = self._fantasy_append_block(work, yh_work, pend_np)
                else:
                    xb = self._tensor(pend_np)
                    rows = self._pending_rows(work, xb, n_live)
                    head_rows = [self._pending_rows(hp, xb, n_live) for hp in head_work]
                    for p, xq in enumerate(xb):
                        work, yh_work, head_work = self._fantasy_append(
                            work, yh_work, xq, rows[..., p, :], head_work,
                            [r[..., p, :] for r in head_rows],
                        )
            if heads is not None:
                head = heads(work, self._pad_heads(yh_work, work), head_work)
        elif len(pend_np) > 0:
            n_excl = min(len(pend_np), cfg.max_pending)
            pend_buf[:n_excl] = pend_np[:n_excl]
            pend_mask[:n_excl] = True

        picks: List[np.ndarray] = []
        out: List[Dict[str, Any]] = []
        for slot in range(k):
            with telemetry.span(
                "suggest.acq_opt", backend=cfg.acq.backend, slot=slot
            ):
                cands, _ = score(
                    work,
                    head,
                    self._tensor(pend_buf),
                    self._tensor(pend_mask, dtype=torch.bool),
                    self._next_key(),
                )
                cands = cands.cpu().numpy()
            with telemetry.span("suggest.dedup", slot=slot):
                config, vec = self._first_unseen(cands, x_all, pend_np, picks)
            out.append(config)
            picks.append(vec)
            if slot + 1 < k:
                if fantasize:
                    work, yh_work, head_work = self._fantasy_append(
                        work, yh_work, self._tensor(vec), None, head_work
                    )
                    if heads is not None:
                        head = heads(work, self._pad_heads(yh_work, work), head_work)
                elif n_excl < cfg.max_pending:
                    pend_buf[n_excl] = vec
                    pend_mask[n_excl] = True
                    n_excl += 1
        self.cache.touched()  # LRU bump + arena budget enforcement
        return out

    def _first_unseen(
        self, cands: np.ndarray, x_all: np.ndarray, pend_np: np.ndarray,
        picks: Sequence[np.ndarray],
    ) -> Tuple[Dict[str, Any], np.ndarray]:
        """The best-ranked candidate that, snapped to the search space, lies
        farther than ``dedupe_tol`` (L∞) from every seen, pending and
        already-picked row; the Sobol fallback if none does."""
        seen = self._seen_matrix(x_all, pend_np, picks)
        for cand in cands:
            snapped = self.space.round_trip(cand)
            if len(seen) == 0 or np.min(
                np.max(np.abs(seen - snapped[None, :]), axis=1)
            ) > self.config.dedupe_tol:
                return self.space.decode(snapped), snapped
        return self._quasi_random(seen)

    # ------------------------------------------------ multi-head decisions
    def _decide_multi(
        self, store: ObservationStore, k: int, pend_np: np.ndarray, ms
    ) -> List[Dict[str, Any]]:
        """One batched decision for an M>1 job (``repro_torch.core.
        multimetric``).

        The objective head (metric column 0) drives the exact single-metric
        machinery — GPHP fitting, the cached factor, rank-1 appends, the
        refit cadence. In the shared-factor layout the extra heads cost one
        batched solve against that cached factor per decision
        (``solve_head_alphas``) plus one matvec per head inside scoring; with
        ``per_head_gphp`` every extra head runs its own GPHP chain and
        factor instead (``_head_posteriors_for``)."""
        cfg = self.config
        n = store.num_observations
        m_all = ms.num_metrics
        num_con = ms.num_constraints
        num_obj = ms.num_objectives

        x_all, ystd, means, scales = store.standardized_metrics()
        post, rows = self._decision_posterior(
            store, x_all, np.ascontiguousarray(ystd[:, 0])
        )
        y_cols = ystd[rows].T  # (M, live) head targets, in factor order
        head_posts = None
        if cfg.per_head_gphp:
            # every extra head runs its own GPHP chain + factor; the shared
            # (S, M, n) alpha block is not built (head 0 scores through the
            # objective posterior directly)
            head_posts = self._head_posteriors_for(store, post, y_cols, n)

        # constraint thresholds + feasibility in standardized space
        t_signed = ms.signed_thresholds()  # (C,) raw signed bounds
        t_std = (t_signed - means[m_all - num_con :]) / scales[m_all - num_con :]
        raw = store.metric_matrix()  # (n, M) signed raw own rows
        if num_con:
            feas_rows = np.all(
                raw[:, m_all - num_con :] <= t_signed[None, :], axis=1
            )
        else:
            feas_rows = np.ones(len(raw), dtype=bool)
        has_feasible = bool(feas_rows.any())

        mode = ms.mode
        if mode == "constrained":
            y_best = float(ystd[feas_rows, 0].min()) if has_feasible else 0.0
            weights = np.zeros((0, num_obj))
            y_best_w = np.zeros((0,))
        else:
            # ParEGO-style random scalarizations: Dirichlet(1) simplex draws
            # from the engine RNG (checkpointed — restored jobs redraw the
            # exact weights an uninterrupted engine would have).
            w_draws = cfg.num_scalarizations
            g = -np.log1p(-self._rng.random((w_draws, num_obj)))
            weights = g / g.sum(axis=1, keepdims=True)
            rows = feas_rows if has_feasible else np.ones(len(raw), bool)
            sc = ystd[:n][rows][:, :num_obj] @ weights.T  # (n_r, W)
            y_best_w = sc.min(axis=0)
            y_best = 0.0

        def make_head(alphas, head_posts_now=()):
            return MultiMetricHead(
                alphas=alphas,
                t_std=self._tensor(t_std),
                y_best=y_best,
                has_feasible=has_feasible,
                weights=self._tensor(weights),
                y_best_w=self._tensor(y_best_w),
                head_posts=tuple(head_posts_now),
            )

        return self._refill_heads(
            k, pend_np, x_all, post, y_cols, mode, make_head, head_posts
        )

    def _decide_cost(
        self,
        store: ObservationStore,
        k: int,
        pend_np: np.ndarray,
        costs: List[Optional[float]],
    ) -> List[Dict[str, Any]]:
        """One batched decision under EI-per-unit-cost (``BOConfig.
        cost_aware``): a GP head over *standardized log-cost* rides the
        shared Cholesky factor, and anchors score

            EIpu(x) = EI(x) · exp(−η · ẑc(x))

        where ẑc is the posterior mean of the log-cost head and η =
        ``cost_cooling`` · max(0, 1 − spent/max_cost) when a capped budget
        ledger is attached (constant ``cost_cooling`` otherwise). Because ẑc
        is standardized, uniform observed costs give ẑc ≡ 0 and EIpu == EI.

        Own rows without a recorded cost — and warm-start parent rows, which
        never carry one — impute target 0 (the head mean)."""
        cfg = self.config
        n = store.num_observations

        x_all, y_std, _, _ = store.standardized()
        post, rows = self._decision_posterior(store, x_all, y_std)

        # standardized log-cost targets over the full store prefix
        zc = np.zeros(n)
        npar = n - len(costs)
        fin = np.asarray(
            [c is not None and math.isfinite(c) and c > 0.0 for c in costs],
            dtype=bool,
        )
        logs = np.asarray(
            [math.log(c) if ok else 0.0 for c, ok in zip(costs, fin)]
        )
        mean = float(logs[fin].mean())
        std = float(logs[fin].std())
        scale = std if std > 1e-12 else 1.0
        zc[npar:][fin] = (logs[fin] - mean) / scale

        ledger = self.budget_ledger
        eta = cfg.cost_cooling
        if ledger is not None and ledger.max_cost is not None:
            eta *= max(0.0, 1.0 - ledger.spent / ledger.max_cost)
        y_best = float(y_std[:n].min())

        def make_head(alphas):
            return MultiMetricHead(
                alphas=alphas,
                t_std=self._tensor(np.zeros((0,))),
                y_best=y_best,
                has_feasible=True,
                weights=self._tensor([[eta]]),  # (1, 1): eta rides weights
                y_best_w=self._tensor(np.zeros((1,))),  # unused in cost mode
            )

        # objective head + log-cost head
        return self._refill_heads(
            k, pend_np, x_all, post, [y_std[rows], zc[rows]], "cost", make_head
        )

    def _decide_rungs(
        self, store: ObservationStore, k: int, pend_np: np.ndarray, mf
    ) -> List[Dict[str, Any]]:
        """One batched decision for a multi-fidelity job whose rung tables
        hold data: the f(x, r) posterior of ``repro_torch.core.gp.
        per_resource``.

        The objective head (final/cummin value) drives the single-metric
        machinery — GPHP chain, cached factor, rank-1 appends, refit
        cadence — untouched; each active rung adds one alpha solve against
        that factor per decision plus one matvec inside scoring (the
        ``"rungs"`` mode of ``acq_score_multi``). Head targets are a pure
        function of (store rows + keys, rung tables), so every replay
        invariant (arena eviction, snapshot restore) holds for the rung
        heads too."""
        cfg = self.config
        if cfg.acq.acq != "ei":
            raise ValueError(
                "multi-fidelity jobs support acq='ei' only (rung-weighted "
                f"EI), got {cfg.acq.acq!r}"
            )
        n = store.num_observations
        num_rungs = mf.num_active_rungs()

        x_all, y_std, _, _ = store.standardized()
        post, rows = self._decision_posterior(store, x_all, y_std)

        # (R, n) standardized rung-head targets; rows without a rung-k value
        # impute their final objective (dense columns — no per-head masks).
        rung_t = rung_head_targets(store, mf.rungs, num_rungs, y_std)
        weights = rung_head_weights(mf.rung_grid, num_rungs)  # (1, R+1)
        # per-head incumbents: each head's EI improves on its own best
        y_best = float(y_std[:n].min())
        y_best_w = np.concatenate(([y_best], rung_t.min(axis=1)))

        def make_head(alphas):
            return MultiMetricHead(
                alphas=alphas,
                t_std=self._tensor(np.zeros((0,))),
                y_best=y_best,
                has_feasible=True,
                weights=self._tensor(weights),
                y_best_w=self._tensor(y_best_w),
            )

        # a span of its own, so a trace can tell the rung-aware decisions
        with telemetry.span("suggest.rungs", rungs=num_rungs, k=k):
            return self._refill_heads(
                k, pend_np, x_all, post, [y_std[rows], *rung_t[:, rows]],
                "rungs", make_head,
            )

    def _refill_heads(
        self, k: int, pend_np: np.ndarray, x_all: np.ndarray, post, y_cols,
        mode: str, make_head, head_posts=None,
    ) -> List[Dict[str, Any]]:
        """``_refill`` for the multi-head decisions: slots score through
        ``optimize_acquisition_multi`` in ``mode``, with the head alphas
        solved on the shared factor after every fold — or, given
        ``head_posts`` (per-head layout), each head's own posterior and no
        shared alpha block."""
        cfg = self.config

        def heads(work, y_block: np.ndarray, posts_now):
            if head_posts is not None:
                return make_head(work.alpha[:, None, :], posts_now)
            with telemetry.device_span(
                "suggest.head_alphas", self.device, heads=len(y_block)
            ):
                return make_head(solve_head_alphas(work, self._tensor(y_block)))

        def score(work, head, pend_buf, pend_mask, key):
            return optimize_acquisition_multi(
                work, head, self._anchors, pend_buf, pend_mask, key, cfg.acq, mode
            )

        return self._refill(
            k, pend_np, x_all, post, y_cols, score, heads, head_posts
        )

    @staticmethod
    def _pad_heads(yh_work, work) -> np.ndarray:
        """Stack per-head target lists into the (M, bucket) padded block."""
        size = work.x_train.shape[0]
        out = np.zeros((len(yh_work), size))
        for j, col in enumerate(yh_work):
            out[j, : len(col)] = col
        return out

    def _refreshed(self, post, col):
        """``post`` with alpha solved for the live rows' targets ``col``."""
        return refresh_alpha(post, self._tensor(self._pad_heads([col], post)[0]))

    def _fantasy_append(
        self, work, yh_work: List[List[float]], xq: torch.Tensor, row=None,
        head_work=(), head_rows=None,
    ):
        """Fold a fantasized observation (pending candidate or interim batch
        pick) into the scratch posterior by a rank-1 append: the input once
        per resident factor (the objective's, plus each per-head factor when
        ``per_head_gphp`` is on), and every head's target list extended by
        its fantasy value — the constant liar, or the kriging believer's
        integrated posterior mean (a head's own posterior where it has one,
        else the shared factor's head alphas). ``row`` / ``head_rows``: the
        factors' cross rows when the caller computed a pending set's rows at
        once (``_pending_rows``)."""
        cfg = self.config
        posts = [work, *head_work]
        if cfg.pending_strategy != "kb":
            vals = [cfg.liar_value] * len(yh_work)
        elif len(posts) == len(yh_work):
            vals = []
            for p in posts:
                mu, _ = gplib.predict(p, xq[None, :], backend=cfg.fit_backend)
                vals.append(float(torch.mean(mu)))
        else:
            alphas_now = solve_head_alphas(
                work, self._tensor(self._pad_heads(yh_work, work))
            )
            mu, _ = predict_heads(
                MultiOutputPosterior(work, alphas_now),
                xq[None, :],
                backend=cfg.fit_backend,
            )  # (S, M, 1)
            vals = [float(v) for v in torch.mean(mu, dim=0)[:, 0].cpu().numpy()]
        live = len(yh_work[0])
        yh_work = [col + [v] for col, v in zip(yh_work, vals)]
        rows = [row, *(head_rows or [None] * len(head_work))]
        folded = [
            self._refreshed(self._append_fantasy_input(p, live, xq, r), col)
            for p, r, col in zip(posts, rows, yh_work)
        ]
        return folded[0], yh_work, folded[1:]

    # ------------------------------------------------------ posterior cache
    def _posterior_for(
        self, store: ObservationStore, x_all: np.ndarray, y_std: np.ndarray
    ):
        """Return a posterior covering the store's n rows, via (in order of
        preference) the cached factors + rank-1 appends, pooled sibling GPHP
        draws (service mode), a refactorization under cached draws
        (replaying the appends since the last refit), or a full GPHP
        refit."""
        cfg = self.config
        cache = self.cache
        pool = cache.pool
        n = x_all.shape[0]
        token = id(store)  # invariant: id-key -- within-process factor-cache identity check only; never serialized, rebuilt per process
        cache.store = store  # arena end-to-end accounting
        self._boundary_refit = False  # did this decision re-fit/adopt draws?

        samples_valid = (
            cfg.incremental
            and cache.samples is not None
            and cache.token in (None, token)
            and cache.n <= n
        )
        post_valid = samples_valid and cache.post is not None
        acct = cache.n if samples_valid else 0
        new_obs = n - acct
        resample = not samples_valid or (
            new_obs > 0 and cache.obs_since_refit + new_obs >= cfg.refit_every
        )

        expected_s = (
            1 if cfg.gphp_method == "map" else cfg.slice_config.num_kept
        )
        if (
            resample
            and cfg.incremental
            and pool is not None
            and pool.samples is not None
            and pool.version > cache.pool_version
            # a sibling fitted with a different GPHP budget: its draw count
            # would silently replace this job's configured fidelity — only
            # adopt shape-compatible draws.
            and pool.samples.shape[0] == expected_s
        ):
            # A sibling job published fresher draws since our last sync:
            # adopt them instead of re-running the chain (the pool-level
            # cadence: across N sibling jobs roughly one chain runs per
            # ``refit_every`` *group* observations). Draws are GPHP
            # posteriors of a sibling's data on the same space, so this is
            # an approximation; ``ServiceConfig(share_gphp=False)`` keeps
            # every chain the standalone engine's.
            cache.samples = np.array(pool.samples)
            cache.pool_version = pool.version
            cache.obs_since_refit = 0
            if self._chain_state is None and pool.chain_state is not None:
                self._chain_state = np.array(pool.chain_state)
            pool.adoptions += 1
            telemetry.count("suggest.gphp.adopt")
            resample = False
            post_valid = False  # factors (if any) describe the old draws
            new_obs = 0  # the adopted draws cover all current rows
            acct = n  # adoption factorizes at n: the new factor boundary
            self._boundary_refit = True

        if pool is not None:
            pool.decisions += 1

        if resample:
            self._boundary_refit = True
            telemetry.count("suggest.gphp.refit")
            rows = self._boundary_rows(x_all, n)
            xj, yj, mj = self._pad_rows(x_all, y_std, rows)
            with telemetry.span("suggest.gphp_fit", n=n):
                samples = self._fit_gphps(xj, yj, mj)  # consumes one RNG key
            cache.samples = np.asarray(samples)
            cache.obs_since_refit = 0
            if pool is not None:
                pool.publish(cache.samples, self._chain_state)
                cache.pool_version = pool.version
            posts, start, fitted = None, n, (xj, [yj], mj)
        elif not post_valid:
            # Cached draws (restored from a checkpoint or snapshot, adopted
            # from the pool, or arena-evicted factors) but no live
            # factorization: replay from the last refit/adoption boundary.
            # The subset backend re-selects its inducing set over [0, start),
            # a deterministic function of the store prefix, so the evicted
            # or snapshotted factor's layout comes back before the appends.
            start = min(n, max(2, acct - cache.obs_since_refit))
            cache.obs_since_refit += new_obs
            self._boundary_rows(x_all[:start], start)
            posts, fitted = None, None
        else:
            posts, start, fitted = [cache.post], acct, None
            cache.obs_since_refit += new_obs
        (post,) = self._advance_factors(
            ("suggest.factorize", "suggest.factor_rebuild", "suggest.rank1_append"),
            posts, [cache.samples], store, start, n, fitted,
            with_inverse=cfg.acq.backend == "kernel",
        )
        cache.n = n
        cache.token = token
        return post

    def _advance_factors(
        self, spans, posts, draws, store: ObservationStore, start: int, n: int,
        fitted=None, with_inverse: bool = False, **attrs,
    ) -> list:
        """The one lifecycle of the engine's factors — the objective's and
        every per-head factor — under fixed draws: bring factors that cover
        the live rows of store prefix ``start`` up to prefix ``n``, under one
        span of ``spans`` = (factorize, rebuild, append) with ``attrs``.

          * ``fitted`` = (x, [y per draw set], mask), the padded rows the
            draws were just fitted on (``start == n``): factorize them.
          * ``posts`` None, no live factor (a restore, an adoption, an arena
            eviction): replay the factorization at the refit boundary
            ``start`` and the rank-1 appends since. RNG-free, and bit for
            bit the factors the uninterrupted engine holds — a size-n
            Cholesky would differ from factorize(start) + appends in the
            last bits, breaking the bit-equivalence snapshots, eviction and
            failover rest on. The factor depends on X only; callers refresh
            alpha against their targets.
          * else rank-1 append store rows [start, n) onto ``posts``."""
        cache = self.cache
        live0 = len(cache.live_rows(start))
        factorize, rebuild, append = spans
        if posts is not None:
            name, attrs = append, dict(n=n, new=n - start, **attrs)
        elif fitted is not None:
            name, attrs = factorize, dict(n=n, **attrs)
        else:
            name, attrs = rebuild, dict(n=n, boundary=start, **attrs)
            xb, yb, mb = self._pad_rows(
                store.x_rows(0, start), np.zeros(start), cache.live_rows(start)
            )
            fitted = (xb, [yb] * len(draws), mb)
        with telemetry.device_span(name, self.device, **attrs):
            if posts is None:
                xb, ys, mb = fitted
                posts = [
                    self._factorize(s, xb, y, mb, with_inverse)
                    for s, y in zip(draws, ys)
                ]
            return [
                self._append_rows(p, store, start, n, live0=live0) for p in posts
            ]

    def _boundary_rows(self, x_prefix: np.ndarray, r: int) -> np.ndarray:
        """Live store rows of a factorization at boundary ``r`` — all of
        ``[0, r)`` on the exact backend, the greedy max-diversity inducing
        set on the subset backend once the boundary reaches ``n_switch``.
        Records the selection on the cache (``inducing_sel``/``inducing_n0``)
        so the append path and target gathering agree with the factor."""
        cfg = self.config
        cache = self.cache
        if cfg.posterior_backend == "subset" and r >= cfg.n_switch:
            with telemetry.span("suggest.select_inducing", n=r,
                                m=cfg.max_inducing):
                sel = select_inducing(x_prefix, cfg.max_inducing)
            cache.inducing_sel = sel
            cache.inducing_n0 = r
            return sel
        cache.inducing_sel = None
        cache.inducing_n0 = 0
        return np.arange(r, dtype=np.int64)

    def _pad_rows(self, x_all: np.ndarray, y_std: np.ndarray, rows: np.ndarray):
        """Gather and bucket-pad the live rows for fitting/factorization."""
        nlive = len(rows)
        nb = bucket_size(nlive)
        x_pad = np.zeros((nb, self.space.encoded_dim))
        y_pad = np.zeros((nb,))
        x_pad[:nlive] = x_all[rows]
        y_pad[:nlive] = y_std[rows]
        mask = np.zeros(nb, dtype=bool)
        mask[:nlive] = True
        return (
            self._tensor(x_pad),
            self._tensor(y_pad),
            self._tensor(mask, dtype=torch.bool),
        )

    def _factorize(self, samples, xj, yj, mj, with_inverse=False):
        """Factorize the masked rows under a draw set. The fused
        anchor-scoring kernel consumes L⁻¹, so the objective's factor builds
        it here and every decision (and fantasy append) reuses the cached
        inverse; per-head factors take none, their scorer being the torch
        composition."""
        params_batch = gpparams.GPHyperParams.unpack(
            self._tensor(samples), self.space.encoded_dim
        )
        return gplib.fit_posterior_batch(
            xj, yj, params_batch, mj, backend=self.config.fit_backend,
            with_inverse=with_inverse,
        )

    def _head_posteriors_for(self, store: ObservationStore, post, y_cols, n):
        """Per-head posteriors for ``BOConfig.per_head_gphp`` — one GPHP
        chain and one factor per extra head, on the objective factor's
        lifecycle (``_advance_factors``): re-fitted at the objective's
        refit/adoption boundaries (one RNG key per head, in head order),
        rank-1-appended between boundaries, and replayed RNG-free after a
        restore or arena eviction. Alphas are refreshed against the live
        targets ``y_cols`` (objective first) every decision. Returns the
        posts in head order (head 1 first)."""
        cache = self.cache
        m_extra = len(y_cols) - 1
        spans = ("suggest.head_factorize", "suggest.head_rebuild",
                 "suggest.head_append")
        stale = (
            cache.head_samples is None or len(cache.head_samples) != m_extra
        )
        if self._boundary_refit or stale:
            xj, mj = post.x_train, post.mask
            samples, posts = [], []
            for j in range(m_extra):
                yj = self._tensor(self._pad_heads([y_cols[j + 1]], post)[0])
                with telemetry.span("suggest.head_gphp_fit", n=n, head=j + 1):
                    s = self._fit_gphps(xj, yj, mj, chain_slot=j)
                samples.append(np.asarray(s))
                posts += self._advance_factors(
                    spans, None, [s], store, n, n, (xj, [yj], mj), head=j + 1
                )
            cache.head_samples = samples
            cache.head_posts = posts
            cache.head_n = n
        elif cache.head_posts is None or cache.head_n < n:
            # the heads follow the objective's boundary and inducing set:
            # both change only at a refit
            start = (
                n - cache.obs_since_refit
                if cache.head_posts is None
                else cache.head_n
            )
            cache.head_posts = self._advance_factors(
                spans, cache.head_posts, cache.head_samples, store, start, n,
                heads=m_extra,
            )
            cache.head_n = n
        cache.head_posts = [
            self._refreshed(hp, y_cols[j + 1])
            for j, hp in enumerate(cache.head_posts)
        ]
        return tuple(cache.head_posts)

    def _append_rows(
        self,
        post,
        store: ObservationStore,
        start: int,
        stop: int,
        live0: int,
    ):
        """Rank-1-append store rows [start, stop), growing the shape bucket
        per row. Growth points depend only on the live-row count, so the
        factor state is a path-independent function of (draws, rows, refit
        boundary); rebuilds replay it bit-exactly.

        ``live0`` is the number of live rows the factor holds before the
        first append: ``start`` on the exact backend (store row == factor
        row), the inducing count plus the appends since the boundary on the
        subset backend, where the factor is smaller than the store."""
        for i in range(start, stop):
            live = live0 + (i - start)
            nb_i = bucket_size(live + 1)
            if post.x_train.shape[0] < nb_i:
                post = grow_posterior(post, nb_i)
            post = posterior_append(
                post, self._tensor(store.x_rows(i, i + 1)[0]), idx=live,
                backend=self.config.fit_backend,
            )
        return post

    def _pending_rows(self, work, xb: torch.Tensor, live: int) -> torch.Tensor:
        """The cross rows of folding xb (R, d) into ``work`` at rows live,
        live + 1, …: one ``gram_rows`` call — one kernel launch — for the
        whole set, on the columns of the bucket the last append lands in.
        Row r equals what its own append would compute."""
        size = max(work.x_train.shape[0], bucket_size(live + len(xb)))
        return gpkernels.gram_rows(
            xb, work.x_train, live, size, work.params, backend=self.config.fit_backend
        )

    def _append_fantasy_input(self, work, live: int, xq: torch.Tensor, row):
        """Grow the bucket if it is full and append xq at row ``live`` (the
        live count, known here: no read-back), its cross row ``row`` from
        ``_pending_rows``, or computed now if None."""
        if row is None:
            row = self._pending_rows(work, xq[None], live)[..., 0, :]
        if live >= work.x_train.shape[0]:
            work = grow_posterior(work, bucket_size(live + 1))
        return posterior_append(
            work, xq, idx=live, cross=row[..., : work.x_train.shape[0]],
            backend=self.config.fit_backend,
        )

    def _fantasy_append_block(
        self, work, yh_work: List[List[float]], x_block: np.ndarray
    ):
        """``_fantasy_append`` of the whole pending set at once, single metric
        and constant liar only (``BOConfig.fantasy_block``): one blocked
        triangular solve per GPHP sample in place of k rank-1 appends."""
        cfg = self.config
        (col,) = yh_work
        need = bucket_size(len(col) + len(x_block))
        if work.x_train.shape[0] < need:
            work = grow_posterior(work, need)
        work = posterior_append_block(
            work, self._tensor(x_block), idx=len(col), backend=cfg.fit_backend
        )
        col = col + [cfg.liar_value] * len(x_block)
        return self._refreshed(work, col), [col]

    # ---------------------------------------------------------------- gphps
    def _fit_gphps(
        self, xj, yj, mj, chain_slot: Optional[int] = None
    ) -> np.ndarray:
        """Sample (or, for ``gphp_method="map"``, optimize) packed GPHPs;
        returns (S, 3d+2) float64 numpy draws (S = 1 for MAP).
        ``chain_slot=None`` is the objective chain; slot ``j`` is the
        warm-start state of extra head ``j+1`` (``per_head_gphp``)."""
        cfg = self.config
        d = self.space.encoded_dim
        bounds = self._bounds
        init = gpparams.default_params(d).pack().numpy()
        init = np.clip(init, bounds.lower + 1e-4, bounds.upper - 1e-4)
        prev_state = (
            self._chain_state
            if chain_slot is None
            else self._head_chain_states.get(chain_slot)
        )
        if prev_state is not None:
            init = np.clip(
                np.asarray(prev_state, dtype=np.float64),
                bounds.lower + 1e-4, bounds.upper - 1e-4,
            )
        if cfg.gphp_method == "map":
            best = map_gphps(
                xj, yj, mj, bounds, init, self._next_key(), cfg.eb_config,
                cfg.fit_backend,
            )
            self._set_chain_state(chain_slot, np.array(best))
            return best[None, :]
        samples = mcmc_gphps(
            xj, yj, mj, bounds, init, self._next_key(), cfg.slice_config,
            cfg.fit_backend,
        )
        self._set_chain_state(chain_slot, np.array(samples[-1]))
        return samples

    def _set_chain_state(
        self, chain_slot: Optional[int], state: np.ndarray
    ) -> None:
        if chain_slot is None:
            self._chain_state = state
        else:
            self._head_chain_states[chain_slot] = state

    # ---------------------------------------------------------- cold starts
    def _seen_matrix(
        self,
        x_all: np.ndarray,
        pend_np: np.ndarray,
        picks: Sequence[np.ndarray],
    ) -> np.ndarray:
        parts = [x_all]
        if len(pend_np):
            parts.append(pend_np)
        if picks:
            parts.append(np.stack(picks, axis=0))
        return np.concatenate(parts, axis=0) if parts else x_all

    def _quasi_random(
        self, seen: np.ndarray
    ) -> Tuple[Dict[str, Any], np.ndarray]:
        """Sobol cold-start / dedupe fallback (§2.1), avoiding ``seen`` rows."""
        for _ in range(32):
            vec = self.space.round_trip(self._sobol_init.next(1)[0])
            if len(seen) == 0 or np.min(
                np.max(np.abs(seen - vec[None, :]), axis=1)
            ) > self.config.dedupe_tol:
                return self.space.decode(vec), vec
        vec = self.space.round_trip(self._rng.random(self.space.encoded_dim))
        return self.space.decode(vec), vec

    # ------------------------------------------------------------ state i/o
    def state_dict(self) -> Dict[str, Any]:
        """JSON-safe image of everything drawn since construction, in the
        JAX package's schema: slice-chain state, numpy RNG and threefry key,
        Sobol position, cached GPHP draws and refit-cadence counters, and the
        multi-fidelity rung tables and budget ledger when they are attached.
        Pair with the construction ``seed`` to rebuild this engine exactly."""
        state = {
            "chain_state": None
            if self._chain_state is None
            else self._chain_state.tolist(),
            "sobol_count": self._sobol_init._count,
            "rng_state": self._rng.bit_generator.state,
            "key": self._key.tolist(),
            "cached_samples": None
            if self.cache.samples is None
            else np.asarray(self.cache.samples).tolist(),
            "cached_n": self.cache.n,
            "obs_since_refit": self.cache.obs_since_refit,
            # per-head GPHP chains (per_head_gphp; None when off)
            "head_chain_states": {
                str(k): v.tolist()
                for k, v in self._head_chain_states.items()
            }
            or None,
            "cached_head_samples": None
            if self.cache.head_samples is None
            else [np.asarray(s).tolist() for s in self.cache.head_samples],
            "cached_head_n": self.cache.head_n,
        }
        # multi-fidelity rung tables ride the suggester state so the Tuner
        # checkpoint carries them without a new channel; key absent when MF
        # is off
        if self.multi_fidelity_state is not None:
            state["multi_fidelity"] = self.multi_fidelity_state.snapshot()
        # budget ledger spend rides the same channel as in the reference; key
        # absent when budgets are off
        if self.budget_ledger is not None:
            state["budget"] = self.budget_ledger.snapshot()
        return state

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Install ``state_dict()`` output — this package's or the JAX
        package's — into a suggester constructed with the same (space,
        config, seed); the next decision continues the original stream."""
        cs = state.get("chain_state")
        self._chain_state = None if cs is None else np.asarray(cs, dtype=np.float64)
        self._sobol_init.reset()
        if state.get("sobol_count", 0):
            self._sobol_init.next(int(state["sobol_count"]))
        if state.get("rng_state") is not None:
            self._rng.bit_generator.state = state["rng_state"]
        self._key = np.asarray(state["key"], dtype=np.uint32)
        samples = state.get("cached_samples")
        self.cache.samples = (
            None if samples is None else np.asarray(samples, dtype=np.float64)
        )
        self.cache.n = int(state.get("cached_n", 0))
        self.cache.obs_since_refit = int(state.get("obs_since_refit", 0))
        self.cache.post = None  # refactorized lazily from cached samples
        self.cache.token = None
        self.cache.inducing_sel = None  # re-selected in the RNG-free rebuild
        self.cache.inducing_n0 = 0
        hcs = state.get("head_chain_states") or {}
        self._head_chain_states = {
            int(k): np.asarray(v, dtype=np.float64) for k, v in hcs.items()
        }
        hs = state.get("cached_head_samples")
        self.cache.head_samples = (
            None if hs is None
            else [np.asarray(s, dtype=np.float64) for s in hs]
        )
        self.cache.head_n = int(state.get("cached_head_n", 0))
        self.cache.head_posts = None  # rebuilt lazily, like the objective's
        self.cache.head_alphas = None
        mf = state.get("multi_fidelity")
        if mf is not None and self.multi_fidelity_state is not None:
            self.multi_fidelity_state.load_snapshot(mf)
        bud = state.get("budget")
        if bud is not None and self.budget_ledger is not None:
            self.budget_ledger.load_snapshot(bud)
        self._wrapper_store = None
        self._wrapper_fps = []


class RandomSuggester:
    """Uniform random search (paper §2.1) — respects log scaling (§5.1)."""

    def __init__(self, space: SearchSpace, seed: int = 0):
        self.space = space
        self._rng = np.random.default_rng(seed)  # invariant: fresh-rng -- constructor-seeded; bit-generator state round-trips through state_dict/load_state_dict

    def suggest(
        self,
        history: Sequence[Observation] = (),
        pending: Sequence[Mapping[str, Any]] = (),
    ) -> Dict[str, Any]:
        return self.space.sample(self._rng, 1)[0]

    def suggest_batch(self, k: int) -> List[Dict[str, Any]]:
        return self.space.sample(self._rng, k)

    def state_dict(self) -> Dict[str, Any]:
        return {"bitgen": self._rng.bit_generator.state}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        self._rng.bit_generator.state = state["bitgen"]


class SobolSuggester:
    """Quasi-random Sobol search (paper §2.1: better space coverage)."""

    def __init__(self, space: SearchSpace, seed: int = 0):
        self.space = space
        self._seq = SobolSequence(space.encoded_dim, shift_rng=np.random.default_rng(seed))  # invariant: fresh-rng -- shift scramble is a pure function of the seed; the sequence position (_count) is the only replay state
        self._count = 0

    def suggest(self, history=(), pending=()) -> Dict[str, Any]:
        return self.suggest_batch(1)[0]

    def suggest_batch(self, k: int) -> List[Dict[str, Any]]:
        self._count += k
        return [
            self.space.decode(self.space.round_trip(v)) for v in self._seq.next(k)
        ]

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self._count}

    def load_state_dict(self, state) -> None:
        self._seq.reset()
        self._count = int(state.get("count", 0))
        if self._count:
            self._seq.next(self._count)
