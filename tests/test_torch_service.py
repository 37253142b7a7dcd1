"""The port's multi-job selection service against the JAX package's.

The reference's ``tests/test_service.py`` runs on the port, each case as a
twin: the same registrations, pushes and decisions in both packages give
the same suggestions (encoded, to 1e-9), the same pool counters (publishes,
adoptions), the same arena evictions (``factor_nbytes`` counts the
reference's blocks) and the same sibling parents. Its
``test_two_jobs_share_service`` twin asserts the reference's own
``num_parents`` on the same inputs (ROADMAP C1: the reference's
``SearchSpace.decode`` overshoots a log-scaled bound here and one sibling
row is not transferable, in both packages alike).

Engine snapshots cross packages: a job snapshotted by one package restores
in the other and continues the same suggestion stream.
"""

import json
import math

import numpy as np
import pytest
import torch

import repro.core as J
from repro.core.gp.slice_sampler import SliceSamplerConfig as JSC
from repro.core.scheduler import SimBackend as JSim
from repro.core.service import space_signature as j_signature
import repro_torch.core as T
from repro_torch.core import rpc as TR
from repro_torch.core.gp.slice_sampler import SliceSamplerConfig as TSC
from repro_torch.core.scheduler import SimBackend as TSim
from repro_torch.core.service import PoolConflictError, SnapshotVersionError, space_signature
from repro_torch.core.trial import TrialState

torch.backends.cuda.matmul.allow_tf32 = False
# pytest-xdist runs the suite in several worker processes; torch's default
# thread pool in each of them oversubscribes the CPU, and these twins (many
# small ops) then run ~10x slower
torch.set_num_threads(1)

PKG = {
    "jax": dict(C=J, SC=JSC, Sim=JSim, kw={}),
    "torch": dict(C=T, SC=TSC, Sim=TSim, kw={"device": "cpu"}),
}


def _space(C):
    return C.SearchSpace([
        C.Continuous("lr", 1e-4, 1.0, scaling="log"),
        C.Continuous("wd", 1e-5, 1e-1, scaling="log"),
    ])


def _other_space(C):
    return C.SearchSpace([
        C.Continuous("alpha", 0.0, 1.0),
        C.Continuous("beta", 0.0, 1.0),
        C.Continuous("gamma", 0.0, 1.0),
    ])


def _obj(cfg):
    return (math.log10(cfg["lr"]) + 2) ** 2 + (math.log10(cfg["wd"]) + 3) ** 2


def _curve(cfg):
    return _obj(cfg) + 2.0 * np.exp(-np.arange(1, 7)), 1.0


def _fill(handle, space, n, seed=0):
    store = getattr(handle, "store", handle)
    pairs = []
    for c in space.sample(np.random.default_rng(seed), n):
        y = _obj(c)
        store.push(c, y)
        pairs.append((c, y))
    return pairs


def _cfg(pkg, **over):
    return PKG[pkg]["C"].BOConfig(num_init=2, **over).fast()


# matched scoring backends: the fused kernels keep L⁻¹ resident (the arena
# counts it), the compositions do not
SCORING = {"torch": {"jax": "xla", "torch": "torch"},
           "kernel": {"jax": "pallas", "torch": "kernel"}}


def _service(pkg, **conf):
    p = PKG[pkg]
    return p["C"].SelectionService(p["C"].ServiceConfig(**conf), **p["kw"])


def _enc(space, configs):
    return np.stack([space.encode(c) for c in configs])


def twin(scenario):
    """Run ``scenario(pkg)`` -> (space, suggestions, facts) in both packages
    and hold the port's to the reference's."""
    js, jout, jfacts = scenario("jax")
    ts, tout, tfacts = scenario("torch")
    np.testing.assert_allclose(_enc(ts, tout), _enc(js, jout), rtol=0, atol=1e-9)
    assert tfacts == jfacts
    return tfacts


# ----------------------------------------------------------------- groups


def test_space_signature_twin():
    for make in (_space, _other_space):
        assert space_signature(make(T)) == j_signature(make(J))
    assert space_signature(_space(T)) != space_signature(_other_space(T))
    a = T.SearchSpace([T.Continuous("x", 0.0, 1.0)])
    b = T.SearchSpace([T.Continuous("x", 0.0, 2.0)])
    assert space_signature(a) != space_signature(b)


# ------------------------------------------------------- sibling warm start


def test_sibling_warm_start_equivalent_to_explicit_pool_twin():
    def scenario(pkg):
        C = PKG[pkg]["C"]
        space = _space(C)
        svc = _service(pkg, share_gphp=False)
        a = svc.register_job("job-a", space, bo_config=_cfg(pkg), seed=0)
        pairs = _fill(a, space, 6, seed=1)
        b = svc.register_job("job-b", space, bo_config=_cfg(pkg), seed=7)
        pool = C.WarmStartPool()
        pool.add_parent(pairs, name="sibling:job-a")
        store = C.ObservationStore(space, warm_start=pool)
        ref = C.BOSuggester(space, _cfg(pkg), seed=7, store=store, **PKG[pkg]["kw"])
        for c, y in _fill(b, space, 3, seed=2):
            store.push(c, y)
        got, want = b.suggest_batch(1)[0], ref.suggest_batch(1)[0]
        np.testing.assert_allclose(space.encode(got), space.encode(want), atol=1e-12)
        return space, [got], {"parents": b.store.num_parents}

    assert twin(scenario) == {"parents": 6}


def test_short_sibling_histories_not_folded():
    svc = _service("torch", share_gphp=False)
    a = svc.register_job("a", _space(T), bo_config=_cfg("torch"))
    _fill(a, _space(T), 1)
    assert svc.register_job("b", _space(T), bo_config=_cfg("torch")).store.num_parents == 0


# ------------------------------------------------------------ GPHP pool


def test_sibling_adopts_published_draws_twin():
    def scenario(pkg):
        space = _space(PKG[pkg]["C"])
        svc = _service(pkg, sibling_warm_start=False)
        a = svc.register_job("a", space, bo_config=_cfg(pkg), seed=0)
        _fill(a, space, 5, seed=1)
        out = a.suggest_batch(1)
        pool = svc.group_pool("a")
        b = svc.register_job("b", space, bo_config=_cfg(pkg), seed=9)
        _fill(b, space, 5, seed=2)
        out += b.suggest_batch(1)  # cold job: adopts the sibling's draws
        np.testing.assert_array_equal(np.asarray(b.suggester.cache.samples),
                                      np.asarray(pool.samples))
        return space, out, pool.stats()

    stats = twin(scenario)
    assert (stats["publishes"], stats["adoptions"]) == (1, 1)
    assert stats["hit_rate"] > 0.0


def test_adoption_requires_matching_sample_count_twin():
    def scenario(pkg):
        p = PKG[pkg]
        space = _space(p["C"])
        svc = _service(pkg, sibling_warm_start=False)
        a = svc.register_job("a", space, bo_config=_cfg(pkg), seed=0)
        _fill(a, space, 5, seed=1)
        out = a.suggest_batch(1)
        hi = p["C"].BOConfig(num_init=2, slice_config=p["SC"](num_samples=44, burn_in=20, thin=2))
        b = svc.register_job("b", space, bo_config=hi, seed=9)
        _fill(b, space, 5, seed=2)
        out += b.suggest_batch(1)
        pool = svc.group_pool("a")
        return space, out, (pool.adoptions, pool.publishes, b.suggester.cache.samples.shape[0])

    assert twin(scenario) == (0, 2, 12)


def test_stale_handle_raises_after_name_reuse():
    svc = _service("torch")
    a1 = svc.register_job("dup", _space(T), bo_config=_cfg("torch"), seed=0)
    a2 = svc.register_job("dup", _space(T), bo_config=_cfg("torch"), seed=1)
    with pytest.raises(RuntimeError, match="stale"):
        a1.suggest_batch(1)
    assert a2.suggest_batch(1)


def test_share_disabled_keeps_chains_standalone():
    space = _space(T)
    svc = _service("torch", share_gphp=False, sibling_warm_start=False)
    a = svc.register_job("a", space, bo_config=_cfg("torch"), seed=0)
    pairs = _fill(a, space, 5, seed=1)
    got = space.encode(a.suggest_batch(1)[0])
    store = T.ObservationStore(space)
    for c, y in pairs:
        store.push(c, y)
    ref = T.BOSuggester(space, _cfg("torch"), seed=0, store=store, device="cpu")
    np.testing.assert_array_equal(got, space.encode(ref.suggest_batch(1)[0]))


# ----------------------------------------------------------- factor arena


@pytest.mark.parametrize("budget_mb,scoring", [
    (1e-6, "torch"), (0.012, "torch"), (1024.0, "torch"), (0.012, "kernel"),
])
def test_arena_eviction_keeps_suggestions_invariant_twin(budget_mb, scoring):
    """A tight arena evicts factors between decisions; the rebuild replays
    the boundary factorization and the appends, so the suggestions equal the
    roomy arena's bit for bit — and both packages evict the same times."""

    def run(pkg, mb):
        space = _space(PKG[pkg]["C"])
        svc = _service(pkg, arena_budget_mb=mb, share_gphp=False,
                       sibling_warm_start=False)
        cfg = _cfg(pkg, refit_every=3, backend=SCORING[scoring][pkg])
        a = svc.register_job("a", space, bo_config=cfg, seed=0)
        b = svc.register_job("b", space, bo_config=cfg, seed=1)
        _fill(a, space, 5, seed=1)
        _fill(b, space, 5, seed=2)
        out = []
        for step in range(3):
            for h in (a, b):
                c = h.suggest_batch(1)[0]
                out.append(c)
                h.store.push(c, _obj(c))
        return space, out, svc.arena.stats()

    def scenario(pkg):
        space, out, stats = run(pkg, budget_mb)
        _, roomy, _ = run(pkg, 1024.0)
        np.testing.assert_array_equal(_enc(space, out), _enc(space, roomy))
        return space, out, stats

    stats = twin(scenario)
    if budget_mb < 1.0:
        assert stats["evictions"] > 0
    else:
        assert stats["evictions"] == 0


def test_arena_tracks_resident_bytes_twin():
    def scenario(pkg):
        space = _space(PKG[pkg]["C"])
        svc = _service(pkg, sibling_warm_start=False)
        a = svc.register_job("a", space, seed=0,
                             bo_config=_cfg(pkg, backend=SCORING["torch"][pkg]))
        _fill(a, space, 5, seed=1)
        before = svc.arena.resident_bytes()
        out = a.suggest_batch(1)
        cache = a.suggester.cache
        return space, out, (before, svc.arena.stats(), cache.factor_nbytes(),
                            cache.store_nbytes())

    before, stats, factor, store = twin(scenario)
    assert before == 0 and stats["resident_bytes"] == factor + store > 0
    assert stats["tracked_jobs"] == 1


def test_different_spaces_never_share_state():
    svc = _service("torch")
    a = svc.register_job("a", _space(T), bo_config=_cfg("torch"), seed=0)
    _fill(a, _space(T), 6, seed=1)
    a.suggest_batch(1)
    pool_a = svc.group_pool("a")
    c = svc.register_job("c", _other_space(T), bo_config=_cfg("torch"), seed=0)
    assert c.store.num_parents == 0
    assert svc.group_pool("c") is not pool_a
    version = pool_a.version
    for cfg in _other_space(T).sample(np.random.default_rng(0), 5):
        c.store.push(cfg, float(sum(cfg.values())))
    c.suggest_batch(1)
    assert pool_a.version == version
    assert svc.group_pool("c").samples is not None


# ------------------------------------------------------- Tuner service mode


def _tuner(pkg, svc, name, trials, path=None):
    p = PKG[pkg]
    return p["C"].Tuner(_space(p["C"]), _curve, None, p["Sim"](),
                        p["C"].TuningJobConfig(max_trials=trials, job_name=name,
                                               checkpoint_path=path),
                        service=svc)


def test_two_jobs_share_service_twin():
    """The reference's ``test_two_jobs_share_service`` on both packages: the
    port transfers exactly the sibling rows the reference does (its own
    ``num_parents``, ROADMAP C1) and makes the same decisions."""

    def scenario(pkg):
        svc = _service(pkg, share_gphp=True, default_bo_config=_cfg(pkg))
        r1 = _tuner(pkg, svc, "fleet-1", 5).run()
        t2 = _tuner(pkg, svc, "fleet-2", 5)
        parents = t2.store.num_parents
        r2 = t2.run()
        assert all(t.state == TrialState.COMPLETED for t in r1.trials + r2.trials)
        stats = svc.stats()
        return (_space(PKG[pkg]["C"]), [t.config for t in r1.trials + r2.trials],
                (parents, stats["groups"][0]["jobs"], stats["groups"][0]["pool"]))

    parents, jobs, _ = twin(scenario)
    assert 1 <= parents <= 5
    assert jobs == ["fleet-1", "fleet-2"]


def test_service_mode_checkpoint_restore_twin(tmp_path):
    def scenario(pkg):
        space = _space(PKG[pkg]["C"])
        svc = _service(pkg, share_gphp=False, default_bo_config=_cfg(pkg))
        seed_job = svc.register_job("seed-job", space, bo_config=_cfg(pkg))
        _fill(seed_job, space, 4, seed=3)
        path = str(tmp_path / f"{pkg}.json")
        r1 = _tuner(pkg, svc, "svc-restore", 4, path).run()
        _fill(seed_job, space, 4, seed=4)  # siblings move on
        t2 = _tuner(pkg, svc, "svc-restore", 4, path)
        t2.restore()
        parents = t2.store.num_parents
        r2 = t2.run()
        assert r2.best_objective == r1.best_objective
        return space, [t.config for t in r1.trials], parents

    assert twin(scenario) == 4  # as registered, not re-folded (8)


def test_restore_without_warm_pool_does_not_fold_siblings(tmp_path):
    svc = _service("torch", share_gphp=False, default_bo_config=_cfg("torch"))
    seed_job = svc.register_job("seed", _space(T), bo_config=_cfg("torch"))
    _fill(seed_job, _space(T), 1, seed=3)
    path = str(tmp_path / "late.json")
    t1 = _tuner("torch", svc, "late", 3, path)
    assert t1.store.num_parents == 0
    t1.run()
    _fill(seed_job, _space(T), 6, seed=4)
    t2 = _tuner("torch", svc, "late", 3, path)
    t2.restore()
    assert t2.store.num_parents == 0


# ---------------------------------------------------------- engine snapshots


def _snapshot_job(pkg, n_obs=7):
    """A warm job mid-cadence: draws cached, appends since the boundary."""
    space = _space(PKG[pkg]["C"])
    svc = _service(pkg, share_gphp=False, sibling_warm_start=False)
    h = svc.register_job("snap", space, bo_config=_cfg(pkg, refit_every=3), seed=4)
    rows = _fill(h, space, n_obs, seed=5)
    for _ in range(2):
        c = h.suggest_batch(1)[0]
        h.store.push(c, _obj(c))
        rows.append((c, _obj(c)))
    return space, svc, h, rows


@pytest.mark.parametrize("src,dst,include_factors", [
    ("jax", "torch", False), ("torch", "jax", False), ("torch", "torch", False),
    ("jax", "torch", True), ("torch", "torch", True),
])
def test_snapshot_restores_across_packages(src, dst, include_factors):
    s_space, _, s_handle, _ = _snapshot_job(src)
    snap = json.loads(json.dumps(
        s_handle.service.snapshot_job("snap", include_factors=include_factors)))
    d_space = _space(PKG[dst]["C"])
    restored = _service(dst, share_gphp=False, sibling_warm_start=False).restore_job(snap)
    for _ in range(2):
        want, got = s_handle.suggest_batch(1)[0], restored.suggest_batch(1)[0]
        np.testing.assert_allclose(d_space.encode(got), s_space.encode(want), rtol=0, atol=1e-9)
        y = _obj(want)
        s_handle.store.push(want, y)
        restored.store.push(want, y)


def test_snapshot_refusals():
    _, svc, _, _ = _snapshot_job("torch")
    snap = svc.snapshot_job("snap")
    with pytest.raises(SnapshotVersionError):
        _service("torch").restore_job({**snap, "snapshot_version": 4})
    # a service holding other draws for the group refuses the snapshot
    other = _service("torch", sibling_warm_start=False)
    h = other.register_job("x", _space(T), bo_config=_cfg("torch"), seed=0)
    _fill(h, _space(T), 5, seed=9)
    h.suggest_batch(1)
    shared = _service("torch", sibling_warm_start=False)
    h2 = shared.register_job("snap", _space(T), bo_config=_cfg("torch"), seed=4)
    _fill(h2, _space(T), 5, seed=5)
    h2.suggest_batch(1)
    snap_shared = shared.snapshot_job("snap")
    with pytest.raises(PoolConflictError):
        other.restore_job(snap_shared)


def test_bo_config_wire_twin():
    from repro.core.rpc import ENGINE_SNAPSHOT_VERSION, bo_config_from_wire, bo_config_to_wire

    assert TR.ENGINE_SNAPSHOT_VERSION == ENGINE_SNAPSHOT_VERSION == 5
    for over in ({}, dict(gphp_method="map", cost_aware=True, fit_backend="torch"),
                 dict(backend="torch", pending_strategy="kb", refit_every=3)):
        tcfg = T.BOConfig(**over)
        blob = json.loads(json.dumps(TR.bo_config_to_wire(tcfg)))
        assert TR.bo_config_from_wire(blob) == tcfg
        jcfg = bo_config_from_wire(blob)  # the reference reads the port's image
        assert bo_config_to_wire(jcfg) == blob
        assert TR.bo_config_from_wire(bo_config_to_wire(jcfg)) == tcfg
