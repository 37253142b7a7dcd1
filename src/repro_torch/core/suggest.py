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

The store's rows stay numpy on the host and become float64 tensors on the
engine's device at the GP boundary. The device is the suggester's
(``device=None`` means the CUDA card; the CPU only when asked for). Random
draws follow the JAX package's threefry key stream (``core/prng.py``), so
the engine makes the reference's decisions and loads its ``state_dict``.

Not ported yet, and refused with ``NotImplementedError``: multi-metric,
multi-fidelity and cost-aware decisions, the subset posterior backend,
per-head GPHP chains, MAP-II fitting and the service-owned cache pool/arena
(ROADMAP queue A items 3 and 7–10).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import prng, telemetry
from repro_torch.core.gp import gp as gplib
from repro_torch.core.gp import params as gpparams
from repro_torch.core.gp.fit import map_gphps, mcmc_gphps
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
from repro_torch.core.history import ObservationStore, bucket_size
from repro_torch.core.optimize_acq import AcqOptConfig, optimize_acquisition
from repro_torch.core.search_space import SearchSpace
from repro_torch.core.sobol import SobolSequence

__all__ = [
    "BOConfig",
    "BOSuggester",
    "EngineCache",
    "RandomSuggester",
    "SobolSuggester",
    "resolve_device",
]

Observation = Tuple[Mapping[str, Any], float]


def resolve_device(device=None) -> torch.device:
    """The engine's device: ``None`` means the CUDA card. Never falls back to
    the CPU quietly — with no card visible, only ``device="cpu"`` runs."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "BOSuggester runs on the CUDA card by default and none is "
            "visible; pass device='cpu' to run on the CPU"
        )
    return dev


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
    """

    num_init: int = 3  # Sobol initial design before the GP takes over
    gphp_method: str = "mcmc"  # "mcmc" (slice sampling) | "map" (not ported)
    slice_config: SliceSamplerConfig = PAPER_CONFIG
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
    fantasy_block: bool = False  # fold the pending set with one rank-k
    # blocked append instead of k rank-1 borders ("liar" strategy only)
    posterior_backend: str = "exact"  # "subset" waits (ROADMAP A10)
    per_head_gphp: bool = False  # waits with multi-metric (ROADMAP A8/A10)
    cost_aware: bool = False  # waits (ROADMAP A9)

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
        if self.posterior_backend == "subset":
            raise NotImplementedError(
                "posterior_backend='subset' is not ported yet "
                "(ROADMAP queue A item 10)"
            )
        if self.posterior_backend != "exact":
            raise ValueError(
                f"unknown posterior_backend {self.posterior_backend!r}"
            )
        if self.per_head_gphp:
            raise NotImplementedError(
                "per_head_gphp is not ported yet (ROADMAP queue A item 10)"
            )
        if self.cost_aware:
            raise NotImplementedError(
                "cost_aware is not ported yet (ROADMAP queue A item 9)"
            )

    def fast(self) -> "BOConfig":
        """Cheaper MCMC settings for many-seed benchmark sweeps."""
        return dataclasses.replace(self, slice_config=FAST_CONFIG)


class EngineCache:
    """The cache block of the incremental BO engine: the packed GPHP draws,
    the factorized ``GPPosterior`` covering the store prefix ``[0, n)`` and
    the refit-cadence accounting. Factors can always be dropped: they
    rebuild from ``samples`` without consuming any RNG state. (The service's
    shared sample pool and factor arena wait with the service, ROADMAP A7.)
    """

    def __init__(self):
        self.samples: Optional[np.ndarray] = None  # packed (S, 3d+2) draws
        self.post = None  # GPPosterior for the live rows
        self.n = 0  # observations folded into the cadence accounting
        self.obs_since_refit = 0
        self.token: Optional[int] = None  # id() of the store the cache maps

    def reset(self) -> None:
        self.samples = None
        self.post = None
        self.n = 0
        self.obs_since_refit = 0
        self.token = None

    def invalidate_factors(self) -> None:
        """Forget the factorization but keep draws + cadence (store rebind)."""
        self.post = None
        self.token = None


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
        device: where the GP numerics run. ``None`` is the CUDA card (a
            ``RuntimeError`` if none is visible); tests pass ``"cpu"``.

    ``state_dict()``/``load_state_dict()`` capture everything *drawn since
    construction*; a JAX ``BOSuggester.state_dict()`` loads unchanged.
    """

    def __init__(
        self,
        space: SearchSpace,
        config: BOConfig = BOConfig(),
        seed: int = 0,
        store: Optional[ObservationStore] = None,
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
        self._store: Optional[ObservationStore] = store
        if store is not None:
            self._check_store(store)
        self._wrapper_store: Optional[ObservationStore] = None
        self._wrapper_fps: List[Tuple[float, bytes]] = []
        self.cache = EngineCache()

    # ------------------------------------------------------------ helpers
    def _tensor(self, arr, dtype=torch.float64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), dtype=dtype).to(self.device)

    def _settle(self) -> None:
        """With telemetry on, wait for the device so the enclosing span
        measures the work and not just its enqueue."""
        if telemetry.enabled() and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ rng
    def _next_key(self) -> np.ndarray:
        self._key, sub = prng.split(self._key)
        return sub

    # ----------------------------------------------------------- store glue
    @staticmethod
    def _check_store(store: ObservationStore) -> None:
        ms = getattr(store, "metrics", None)
        if ms is not None and ms.num_metrics > 1:
            raise NotImplementedError(
                "multi-metric stores are not ported yet (ROADMAP queue A item 8)"
            )

    def bind_store(self, store: ObservationStore) -> None:
        """Attach the engine to a live observation store (the Tuner does this
        at construction and after restore). Cached GPHP samples survive a
        rebind; the factorization is rebuilt lazily against the new store."""
        self._check_store(store)
        self._store = store
        self.cache.invalidate_factors()

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
            "suggest.decide", n=store.num_observations, k=k
        ):
            return self._decide_impl(store, k, pend_np)

    def _decide_impl(
        self, store: ObservationStore, k: int, pend_np: np.ndarray
    ) -> List[Dict[str, Any]]:
        cfg = self.config
        space = self.space
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

        x_all, y_std, _, _ = store.standardized()
        with telemetry.span("suggest.posterior", n=n):
            post = self._posterior_for(store, x_all, y_std)
        y_live = np.zeros(post.x_train.shape[0])
        y_live[:n] = y_std
        post = refresh_alpha(post, self._tensor(y_live))
        self.cache.post = post
        y_best = float(y_std.min())  # best *real* observation

        # --- pending (§4.4) + scratch posterior for fantasies ---------------
        d = space.encoded_dim
        pend_buf = np.zeros((cfg.max_pending, d))
        pend_mask = np.zeros(cfg.max_pending, dtype=bool)
        n_excl = 0
        work = post
        y_work = list(y_live[:n])
        if cfg.pending_strategy in ("liar", "kb") and len(pend_np) > 0:
            if (
                cfg.fantasy_block
                and cfg.pending_strategy == "liar"
                and len(pend_np) > 1
            ):
                work, y_work = self._fantasy_append_block(work, y_work, pend_np)
            else:
                for xp in pend_np:
                    work, y_work = self._fantasy_append(work, y_work, xp)
        elif len(pend_np) > 0:
            n_excl = min(len(pend_np), cfg.max_pending)
            pend_buf[:n_excl] = pend_np[:n_excl]
            pend_mask[:n_excl] = True

        # --- batched refill: one pipeline pass fills all k slots -------------
        for slot in range(k):
            with telemetry.span(
                "suggest.acq_opt", backend=cfg.acq.backend, slot=slot
            ):
                cands, _ = optimize_acquisition(
                    work,
                    self._anchors,
                    y_best,
                    self._tensor(pend_buf),
                    self._tensor(pend_mask, dtype=torch.bool),
                    self._next_key(),
                    cfg.acq,
                )
                cands = cands.cpu().numpy()
            with telemetry.span("suggest.dedup", slot=slot):
                seen = self._seen_matrix(x_all, pend_np, picks)
                config = vec = None
                for cand in cands:
                    snapped = space.round_trip(cand)
                    if len(seen) == 0 or np.min(
                        np.max(np.abs(seen - snapped[None, :]), axis=1)
                    ) > cfg.dedupe_tol:
                        config, vec = space.decode(snapped), snapped
                        break
                if config is None:
                    config, vec = self._quasi_random(seen)
            out.append(config)
            picks.append(vec)
            if slot + 1 < k:
                if cfg.pending_strategy in ("liar", "kb"):
                    work, y_work = self._fantasy_append(work, y_work, vec)
                elif n_excl < cfg.max_pending:
                    pend_buf[n_excl] = vec
                    pend_mask[n_excl] = True
                    n_excl += 1
        return out

    # ------------------------------------------------------ posterior cache
    def _posterior_for(
        self, store: ObservationStore, x_all: np.ndarray, y_std: np.ndarray
    ):
        """Return a posterior covering the store's n rows, via (in order of
        preference) the cached factors + rank-1 appends, a refactorization
        under cached draws (replaying the appends since the last refit), or
        a full GPHP refit."""
        cfg = self.config
        cache = self.cache
        n = x_all.shape[0]
        token = id(store)  # invariant: id-key -- within-process factor-cache identity check only; never serialized, rebuilt per process

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

        if resample:
            telemetry.count("suggest.gphp.refit")
            xj, yj, mj = self._pad_rows(x_all, y_std, n)
            with telemetry.span("suggest.gphp_fit", n=n):
                samples = self._fit_gphps(xj, yj, mj)  # consumes one RNG key
            cache.samples = np.asarray(samples)
            cache.obs_since_refit = 0
            with telemetry.span("suggest.factorize", n=n):
                post = self._factorize(xj, yj, mj)
                self._settle()
        elif not post_valid:
            # Cached draws (restored from a checkpoint, or dropped factors)
            # but no live factorization. The factors the uninterrupted engine
            # holds were built by a full factorization at its last refit
            # boundary followed by rank-1 appends — so the rebuild *replays*
            # that exact op sequence instead of refactorizing at n (a size-n
            # Cholesky differs from factorize(r)+appends in the last bits).
            # RNG-free.
            r = min(n, max(2, acct - cache.obs_since_refit))
            cache.obs_since_refit += new_obs
            xj, yj, mj = self._pad_rows(x_all, y_std, r)
            with telemetry.span("suggest.factor_rebuild", n=n, boundary=r):
                post = self._factorize(xj, yj, mj)
                post = self._append_rows(post, store, r, n)
                self._settle()
        else:
            with telemetry.span("suggest.rank1_append", n=n, new=new_obs):
                post = self._append_rows(cache.post, store, acct, n)
                self._settle()
            cache.obs_since_refit += new_obs

        cache.n = n
        cache.token = token
        return post

    def _pad_rows(self, x_all: np.ndarray, y_std: np.ndarray, nlive: int):
        """Bucket-pad the first ``nlive`` rows for fitting/factorization."""
        nb = bucket_size(nlive)
        x_pad = np.zeros((nb, self.space.encoded_dim))
        y_pad = np.zeros((nb,))
        x_pad[:nlive] = x_all[:nlive]
        y_pad[:nlive] = y_std[:nlive]
        mask = np.zeros(nb, dtype=bool)
        mask[:nlive] = True
        return (
            self._tensor(x_pad),
            self._tensor(y_pad),
            self._tensor(mask, dtype=torch.bool),
        )

    def _factorize(self, xj, yj, mj):
        """Factorize the masked rows under the cached GPHP draws. The fused
        anchor-scoring kernel consumes L⁻¹; build it at factorization time so
        every decision (and fantasy append) reuses the cached inverse."""
        params_batch = gpparams.GPHyperParams.unpack(
            self._tensor(self.cache.samples), self.space.encoded_dim
        )
        return gplib.fit_posterior_batch(
            xj, yj, params_batch, mj, backend=self.config.fit_backend,
            with_inverse=self.config.acq.backend == "kernel",
        )

    def _append_rows(self, post, store: ObservationStore, start: int, stop: int):
        """Rank-1-append store rows [start, stop), growing the shape bucket
        per row. Growth points depend only on the live-row count, so the
        factor state is a path-independent function of (draws, rows, refit
        boundary); rebuilds replay it bit-exactly."""
        for i in range(start, stop):
            nb_i = bucket_size(i + 1)
            if post.x_train.shape[0] < nb_i:
                post = grow_posterior(post, nb_i)
            post = posterior_append(
                post, self._tensor(store.x_rows(i, i + 1)[0]),
                backend=self.config.fit_backend,
            )
        return post

    def _fantasy_append(self, work, y_work: List[float], x_vec: np.ndarray):
        """Fold a fantasized observation (pending candidate or interim batch
        pick) into the scratch posterior via the rank-1 append."""
        cfg = self.config
        xq = self._tensor(x_vec)
        if cfg.pending_strategy == "kb":
            mu, _ = gplib.predict(work, xq[None, :], backend=cfg.fit_backend)
            val = float(torch.mean(mu))  # kriging believer: integrated mean
        else:
            val = cfg.liar_value  # constant liar in standardized space
        live = len(y_work)
        if live >= work.x_train.shape[0]:
            work = grow_posterior(work, bucket_size(live + 1))
        work = posterior_append(work, xq, backend=cfg.fit_backend)
        y_work = y_work + [val]
        y_pad = np.zeros(work.x_train.shape[0])
        y_pad[: len(y_work)] = y_work
        return refresh_alpha(work, self._tensor(y_pad)), y_work

    def _fantasy_append_block(
        self, work, y_work: List[float], x_block: np.ndarray
    ):
        """Rank-k blocked fantasy fold (``BOConfig.fantasy_block``): one
        blocked triangular solve per GPHP sample folds the whole pending set
        (constant-liar values only)."""
        cfg = self.config
        k = len(x_block)
        live = len(y_work)
        need = bucket_size(live + k)
        if work.x_train.shape[0] < need:
            work = grow_posterior(work, need)
        work = posterior_append_block(
            work, self._tensor(x_block), backend=cfg.fit_backend
        )
        y_work = y_work + [cfg.liar_value] * k
        y_pad = np.zeros(work.x_train.shape[0])
        y_pad[: len(y_work)] = y_work
        return refresh_alpha(work, self._tensor(y_pad)), y_work

    # ---------------------------------------------------------------- gphps
    def _fit_gphps(self, xj, yj, mj) -> np.ndarray:
        """Sample packed GPHPs; returns (S, 3d+2) float64 numpy draws."""
        cfg = self.config
        d = self.space.encoded_dim
        bounds = self._bounds
        init = gpparams.default_params(d).pack().numpy()
        init = np.clip(init, bounds.lower + 1e-4, bounds.upper - 1e-4)
        if self._chain_state is not None:
            init = np.clip(
                np.asarray(self._chain_state, dtype=np.float64),
                bounds.lower + 1e-4, bounds.upper - 1e-4,
            )
        if cfg.gphp_method == "map":
            return map_gphps()
        samples = mcmc_gphps(
            xj, yj, mj, bounds, init, self._next_key(), cfg.slice_config,
            cfg.fit_backend,
        )
        self._chain_state = np.array(samples[-1])
        return samples

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
        Sobol position, cached GPHP draws and refit-cadence counters. Pair
        with the construction ``seed`` to rebuild this engine exactly."""
        return {
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
            "head_chain_states": None,
            "cached_head_samples": None,
            "cached_head_n": 0,
        }

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Install ``state_dict()`` output — this package's or the JAX
        package's — into a suggester constructed with the same (space,
        config, seed); the next decision continues the original stream."""
        if state.get("head_chain_states") or state.get("cached_head_samples"):
            raise NotImplementedError(
                "per-head GPHP state is not ported yet (ROADMAP queue A item 10)"
            )
        if state.get("multi_fidelity") is not None or state.get("budget") is not None:
            raise NotImplementedError(
                "multi-fidelity and budget state are not ported yet "
                "(ROADMAP queue A items 6 and 9)"
            )
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
