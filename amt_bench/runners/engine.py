"""Runner of the engine cells: closed-loop BO tuning jobs on the program's
``BOSuggester`` (one job) or ``SelectionService`` (many jobs).

Traffic (``workloads/<cell>.json``): ``jobs`` jobs, each ``trials`` trials
long with ``in_flight`` trials running. A job's oldest trial completes first
(the virtual clock of ``SimBackend`` with equal trial times); its slot is
refilled by one ``suggest_batch`` call. Jobs take turns, one call each, as
``chip_smoke.py``'s ``service_pair`` interleaves two (a frozen copy of that
loop and of ``run_job``'s objective, commit 34e7d4a). A finished job is
replaced by a new one with the next seed. Every job's seed, optimum and
weights are drawn from ``--seed`` and the job's index.

Timed: every ``suggest_batch`` call of the window, from the call to the
configurations on the host (with ``torch.cuda.synchronize()``).

Checked once the window has closed (``check``): a sample of the window's GP
decisions, drawn from the seed and holding the one with the most rows, is
decided again by the plain reference (``reference/bo_decision.py``) from the
job's history, its trials in flight and the GPHP samples the decision used;
the program's pick is judged by its integrated EI (float64) against the
reference's pick. The GPHP samples of the same decisions are made again by
the plain slice chain (``reference/gphp_chain.py``) on the draws the job's
seed determines: a refit's from the job's rows, an adoption's as the chain
of the sibling whose draws the shared pool held (the reference keeps the
pool's rule: a job adopts when a sibling has published since its own last
refit or adoption). The cold start is regenerated from the job's seed.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List

import numpy as np

from amt_bench.harness import derive_seed
from amt_bench.reference import bo_decision as R
from amt_bench.reference import gphp_chain as G


def make_objective(obj: Dict[str, Any], space, seed: int):
    """The seeded objective of ``chip_smoke.py`` (frozen): the final loss of
    a learning curve whose floor is a weighted quadratic bowl around an
    optimum drawn from ``seed``, plus a small wiggle."""
    rng = np.random.default_rng(seed)
    opt = rng.random(len(space))
    weights = obj["weight_low"] + rng.random(len(space))
    t_last = float(obj["curve_points"])

    def objective(config) -> float:
        u = R.encode(space, config)
        floor = obj["floor"] + float(np.sum(weights * (u - opt) ** 2))
        floor += obj["wiggle"] * math.sin(obj["wiggle_freq"] * float(np.sum(u)))
        return floor + obj["curve_amp"] * math.exp(-obj["curve_rate"] * t_last)

    return objective


class Job:
    """One tuning job: its engine handle, its own history and its slots."""

    def __init__(self, cell: "Cell", index: int, slot: int):
        self.index = index
        self.seed = derive_seed(cell.seed, index)
        self.space_spec = cell.space_spec
        self.objective = make_objective(cell.conf["objective"], cell.space_spec, self.seed)
        self.handle, self.store = cell.new_engine(slot, self.seed)
        self.inflight: List[tuple] = []
        self.x_obs: List[np.ndarray] = []
        self.y_obs: List[float] = []
        self.tried = 0

    def done(self, trials: int) -> bool:
        return self.tried >= trials and not self.inflight

    def complete_oldest(self) -> None:
        tid, config = self.inflight.pop(0)
        y = self.objective(config)
        self.store.clear_pending(tid)
        self.store.push(config, y, key=tid)
        self.x_obs.append(R.encode(self.space_spec, config))
        self.y_obs.append(y)


class Cell:
    def __init__(self, conf, workload, seed: int, device):
        self.conf, self.wl, self.seed, self.device = conf, workload, seed, device
        self.space_spec = conf["space"]
        self.service = None
        self.decisions: List[Dict[str, Any]] = []  # every timed call
        self.setup_parts: Dict[str, float] = {}

    # ----------------------------------------------------------- program
    def _engine_config(self):
        from repro_torch.core import BOConfig
        from repro_torch.core.gp.slice_sampler import SliceSamplerConfig
        from repro_torch.core.optimize_acq import AcqOptConfig

        e = self.conf["engine"]
        return BOConfig(
            num_init=e["num_init"],
            slice_config=SliceSamplerConfig(**e["slice"]),
            acq=AcqOptConfig(**e["acq"]),
            refit_every=e["refit_every"], backend=e["backend"],
            fit_backend=e["fit_backend"], pending_strategy=e["pending_strategy"],
            liar_value=e["liar_value"], dedupe_tol=e["dedupe_tol"],
        )

    def _space(self):
        from repro_torch.core import Continuous, Integer, SearchSpace

        params = []
        for p in self.space_spec:
            kind = Integer if p["type"] == "integer" else Continuous
            params.append(kind(p["name"], p["low"], p["high"], scaling=p.get("scaling", "linear")))
        return SearchSpace(params)

    def new_engine(self, slot: int, seed: int):
        """(the handle whose ``suggest_batch`` decides, the job's store); a
        service job takes its slot's name, so a new job replaces the old."""
        if self.service is not None:
            handle = self.service.register_job(f"job-{slot}", self.space, seed=seed)
            return handle, handle.store
        from repro_torch.core import BOSuggester
        from repro_torch.core.history import ObservationStore

        store = ObservationStore(self.space)
        return BOSuggester(self.space, self.bo_config, seed=seed, store=store,
                           device=self.device), store

    def _start(self, first_index: int, jobs: int) -> None:
        from repro_torch.core import SelectionService, ServiceConfig

        self.bo_config = self._engine_config()
        svc = self.wl.get("service")
        self.service = None
        if svc is not None:
            self.service = SelectionService(
                ServiceConfig(default_bo_config=self.bo_config, **svc), device=self.device)
        self.next_index = first_index
        self.jobs = []
        for slot in range(jobs):
            self.jobs.append(self._new_job(slot))

    def _new_job(self, slot: int) -> Job:
        self.next_index += 1
        return Job(self, self.next_index - 1, slot)

    def _stagger(self) -> None:
        """Start job slot i of J with i·trials/J trials already done, at
        configurations drawn from its seed, so the window's jobs are at
        different stages from the first call on."""
        d = len(self.space_spec)
        for i, job in enumerate(self.jobs):
            rng = np.random.default_rng(derive_seed(job.seed, 99))
            for _ in range(i * self.wl["trials"] // len(self.jobs)):
                config = R.decode(self.space_spec, rng.random(d))
                job.inflight.append((job.tried, config))
                job.store.mark_pending(job.tried, config)
                job.tried += 1
                job.complete_oldest()

    # ------------------------------------------------------------- loop
    def _turn(self, j: int, timed: bool, tracer=None) -> None:
        """One turn of job slot ``j``: complete a trial, refill, time it."""
        import torch

        trials, in_flight = self.wl["trials"], self.wl["in_flight"]
        job = self.jobs[j]
        if job.done(trials):
            job = self.jobs[j] = self._new_job(j)
        if job.inflight and (len(job.inflight) == in_flight or job.tried == trials):
            job.complete_oldest()
        free = min(in_flight - len(job.inflight), trials - job.tried)
        if free <= 0:
            return
        n = len(job.y_obs)
        pending = np.array([R.encode(self.space_spec, c) for _, c in job.inflight]).reshape(
            -1, len(self.space_spec))
        t0 = time.perf_counter()
        batch = job.handle.suggest_batch(free)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if tracer is not None:
            tracer.after_call()
        picks = [R.encode(self.space_spec, c) for c in batch]
        if timed:
            gp = n >= max(2, self.bo_config.num_init)
            rec = {"ms": ms, "job": job.index, "seed": job.seed, "n": n, "k": free, "gp": gp,
                   "picks": picks, "pending": pending}
            if gp:
                cache = job.handle.suggester.cache if self.service is not None else job.handle.cache
                rec.update(x=np.array(job.x_obs), y=np.array(job.y_obs),
                           samples=np.array(cache.samples))
            self.decisions.append(rec)
        for c in batch:
            job.store.mark_pending(job.tried, c)
            job.inflight.append((job.tried, c))
            job.tried += 1

    # ------------------------------------------------------------ phases
    def setup(self) -> None:
        """Build or load the kernels, then warm the cell's shapes: one job
        (a seed the window never uses) decides once at each row count of
        ``warmup_rows``, with ``in_flight - 1`` trials in flight, so every
        row bucket the window reaches is factorized, grown into and scored."""
        import torch

        t = time.perf_counter()
        if self.device.type == "cuda":
            from repro_torch.kernels import _build

            _build.build_all()
            for lib in _build.SOURCES:
                _build.library(lib)
        self.setup_parts["kernels_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.space = self._space()
        self._start(first_index=1 << 20, jobs=1)
        job = self.jobs[0]
        rng = np.random.default_rng(derive_seed(self.seed, 1 << 21))
        d = len(self.space_spec)
        for n in self.wl["warmup_rows"]:
            while len(job.y_obs) < n:
                config = R.decode(self.space_spec, rng.random(d))
                job.inflight.append((("w", len(job.y_obs)), config))
                job.store.mark_pending(job.inflight[-1][0], config)
                job.complete_oldest()
            keys = [("p", n, i) for i in range(self.wl["in_flight"] - 1)]
            for key in keys:
                job.store.mark_pending(key, R.decode(self.space_spec, rng.random(d)))
            job.handle.suggest_batch(1)
            for key in keys:
                job.store.clear_pending(key)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self._start(first_index=0, jobs=self.wl["jobs"])
        if self.wl.get("stagger"):
            self._stagger()
        self.setup_parts["warmup_s"] = time.perf_counter() - t

    def window(self, seconds: float, tracer=None) -> Dict[str, Any]:
        """Closed loop until ``seconds`` have passed; returns the window's
        record for the metric readers."""
        if tracer is not None:
            tracer.start()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        j = 0
        while time.perf_counter() < deadline:
            self._turn(j, timed=True, tracer=tracer)
            j = (j + 1) % len(self.jobs)
        wall = time.perf_counter() - t0
        if tracer is not None:
            tracer.stop()
        calls = [{k: d[k] for k in ("ms", "gp", "n", "k")} for d in self.decisions]
        return {"window_s": wall, "call_ms": [c["ms"] for c in calls], "calls": calls,
                "attempted": len(calls), "failed": 0}

    # ------------------------------------------------------------- check
    def _sampled(self) -> List[Dict[str, Any]]:
        """The GP decisions checked: the one with the most rows and a
        sample of the rest drawn from the seed."""
        gp = [d for d in self.decisions if d["gp"]]
        if not gp:
            return []
        rng = np.random.default_rng(derive_seed(self.seed, 7))
        first = max(range(len(gp)), key=lambda i: (gp[i]["n"], i))
        rest = [i for i in range(len(gp)) if i != first]
        size = min(len(rest), self.wl["check"]["decisions"] - 1)
        chosen = {first, *rng.choice(rest, size=size, replace=False).tolist()} if rest else {first}
        return [gp[i] for i in sorted(chosen)]

    def _ei_gap(self, pick_of) -> tuple:
        """The widest EI shortfall of ``pick_of(decision)`` behind the
        reference's pick over the sampled decisions; a decision whose pick
        cannot be made (a gram not positive definite at the precision
        asked) counts as infinitely short."""
        engine = self.conf["engine"]
        gaps = []
        for d in self._sampled():
            args = (self.space_spec, engine, d["x"], d["y"], d["pending"], d["samples"])
            try:
                want = R.decide(*args, 1, device=self.device)[0]
                gaps.append(R.ei_gap(*args, pick_of(d), want, device=self.device))
            except R.FactorError:
                gaps.append(math.inf)
        finite = [g for g in gaps if math.isfinite(g)]
        self.detail = {"ei_gap_finite_max": max(finite) if finite else None,
                       "unfactorized": len(gaps) - len(finite)}
        return ("ei_gap", max(gaps) if gaps else math.inf, self.wl["limits"]["ei_gap"],
                len(gaps))

    def check(self) -> List[tuple]:
        """(number, value, limit, count) of every number compared."""
        limits = self.wl["limits"]
        return [self._ei_gap(lambda d: d["picks"][0]),
                self._gphp_gap(np.float64),
                ("cold_start_dx", self._cold_start_dx(), limits["cold_start_dx"], None)]

    def control(self) -> List[tuple]:
        """The check with the reference in float32 put in the program's
        place, on the cell's device: its picks judged as the program's are,
        and its GPHP chains against the float64 chains."""
        import torch

        engine = self.conf["engine"]
        return [self._ei_gap(lambda d: R.decide(
            self.space_spec, engine, d["x"], d["y"], d["pending"], d["samples"], 1,
            dtype=torch.float32, device=self.device)[0]),
            self._gphp_gap(np.float32)]

    def _gphp_plan(self) -> Dict[int, tuple]:
        """For every GP decision of the window (by ``id``), how the
        reference makes its samples: ("refit", key, start) or ("adopt",
        the publishing decision)."""
        d = len(self.space_spec)
        shared = (self.wl.get("service") or {}).get("share_gphp", False)
        keys, start, sync = {}, {}, {}
        version, publisher, plan = 0, None, {}
        for rec in self.decisions:
            if not rec["gp"]:
                continue
            j = rec["job"]
            stream = keys.setdefault(j, G.job_keys(rec["seed"]))
            if shared and version > sync.get(j, 0):
                plan[id(rec)] = ("adopt", publisher)
                sync[j] = version
                start.setdefault(j, publisher["samples"][-1])
            else:
                z0 = G.clipped_start(start[j]) if j in start else G.first_start(d)
                plan[id(rec)] = ("refit", next(stream), z0)
                start[j] = rec["samples"][-1]  # the program's chain state
                if shared:
                    version += 1
                    sync[j], publisher = version, rec
            for _ in range(rec["k"]):  # one key a configuration picked
                next(stream)
        return plan

    def _gphp_gap(self, dtype) -> tuple:
        """The widest gap (packed log space, L∞) between the GPHP samples
        of the sampled decisions and the reference chain's; with ``dtype``
        float32 the float32 chain stands in the program's place."""
        sc = self.conf["engine"]["slice"]
        plan, made = self._gphp_plan(), {}

        def reference(rec, dt):
            key = (id(rec), dt)
            if key not in made:
                how = plan[id(rec)]
                if how[0] == "adopt":
                    made[key] = reference(how[1], dt)
                else:
                    made[key] = G.chain(rec["x"], R.standardize(rec["y"]), how[2], how[1],
                                        sc["num_samples"], sc["burn_in"], sc["thin"], dt)
            return made[key]

        gaps = []
        for rec in self._sampled():
            want = reference(rec, np.float64)
            got = rec["samples"] if dtype == np.float64 else reference(rec, dtype)
            gaps.append(float(np.max(np.abs(np.asarray(got) - want))))
        return ("gphp_gap", max(gaps) if gaps else math.inf,
                self.wl["limits"]["gphp_gap"], len(gaps))

    def _cold_start_dx(self) -> float:
        """Largest L∞ distance between the program's cold-start picks and the
        reference's: the job's shifted Sobol sequence, rounded to the space,
        in the order the calls drew it."""
        d = len(self.space_spec)
        by_job: Dict[int, List[np.ndarray]] = {}
        seeds = {}
        for rec in self.decisions:
            if not rec["gp"]:
                by_job.setdefault(rec["job"], []).extend(rec["picks"])
                seeds[rec["job"]] = rec["seed"]
        if not by_job:
            return math.inf
        worst = 0.0
        for job, picks in by_job.items():
            ref = R.cold_start(self.space_spec, seeds[job], len(picks))
            worst = max(worst, float(np.max(np.abs(np.array(picks) - ref))))
        return worst
