"""The port's multi-fidelity engine against the JAX package's: in-service
ASHA promotion and the per-rung f(x, r) heads.

* ``MultiFidelityState`` is a numpy-only copy: the reference's decision
  semantics (idempotent keyed recording, memoized decisions, quantile
  promotion, snapshots) hold on the port, and a rung snapshot crosses
  packages.
* ``rung_head_targets`` / ``rung_head_weights`` equal the reference's, and
  ``rung_weighted_ei`` — the torch closed form behind the plain ``"rungs"``
  mode of ``acq_score_multi`` — equals the reference's jnp form to 1e-12.
* A multi-fidelity ``Tuner`` in service mode on ``SimBackend`` makes the
  JAX package's decisions (tables to 1e-9), stops the same trials at the
  same rungs and ends with the same rung tables; the reference's
  end-to-end cases (resource savings, MF-off identity, validation, goal
  signing, checkpoint kill/restore) run on the port. The socket and
  replica cases wait with the wire (ROADMAP A11).
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core.asha import ASHAConfig as JASHA
from repro.core.gp import per_resource as JPR
from repro.core.multifidelity import MultiFidelityState as JMFS
from repro.core.scheduler import SimBackend as JSim
import repro_torch.core as T
from repro_torch.core.asha import ASHAConfig, rung_iters
from repro_torch.core.gp import per_resource as TPR
from repro_torch.core.median_rule import MedianRule
from repro_torch.core.multifidelity import MultiFidelityState
from repro_torch.core.multimetric import MetricSpec
from repro_torch.core.scheduler import SimBackend as TSim
from repro_torch.core.trial import TrialState

torch.backends.cuda.matmul.allow_tf32 = False
# pytest-xdist runs the suite in several worker processes; torch's default
# thread pool in each of them oversubscribes the CPU, and these twins (many
# small ops) then run ~10x slower
torch.set_num_threads(1)

PKG = {
    "jax": dict(C=J, Sim=JSim, kw={}),
    "torch": dict(C=T, Sim=TSim, kw={"device": "cpu"}),
}


def _space(C=T):
    return C.SearchSpace([
        C.Continuous("lr", 1e-4, 1.0, scaling="log"),
        C.Continuous("wd", 1e-5, 1e-1, scaling="log"),
    ])


def _floor(cfg):
    return (math.log10(cfg["lr"]) + 2) ** 2 + (math.log10(cfg["wd"]) + 3) ** 2


def _curve(cfg):
    return _floor(cfg) + 2.0 * np.exp(-0.15 * np.arange(1, 28)), 1.0


def _mf(C):
    return (JASHA if C is J else ASHAConfig)(r_min=3, eta=3, max_rungs=3)


def _svc(pkg, **conf):
    p = PKG[pkg]
    C = p["C"]
    conf.setdefault("default_bo_config", C.BOConfig(num_init=3).fast())
    return C.SelectionService(C.ServiceConfig(**conf), **p["kw"])


def _make(pkg, svc, mf="default", max_trials=10, path=None, callbacks=(), seed=3):
    p = PKG[pkg]
    C = p["C"]
    return C.Tuner(
        _space(C), _curve, None, p["Sim"](),
        C.TuningJobConfig(max_trials=max_trials, job_name="mf-job", seed=seed,
                          multi_fidelity=_mf(C) if mf == "default" else mf,
                          checkpoint_path=path),
        service=svc, callbacks=callbacks,
    )


def _table(result):
    return [(t.trial_id, t.config, str(t.state), t.objective, len(t.curve))
            for t in result.trials]


def assert_same_tables(res_t, res_j, atol=1e-9):
    space = _space()
    assert len(res_t.trials) == len(res_j.trials)
    for a, b in zip(res_t.trials, res_j.trials):
        assert (a.trial_id, str(a.state), len(a.curve)) == (b.trial_id, str(b.state), len(b.curve))
        np.testing.assert_allclose(space.encode(a.config), space.encode(b.config),
                                   rtol=0, atol=atol)
        assert a.objective == pytest.approx(b.objective, abs=atol)


def _promo(handle):
    return json.loads(json.dumps(handle.promotion()))


# ------------------------------------------------- MultiFidelityState alone


class TestMultiFidelityState:
    def test_non_rung_iteration_is_noop(self):
        st = MultiFidelityState(ASHAConfig(r_min=2, eta=2, max_rungs=3))
        assert st.report_rung(0, 3, 1.0) == ("continue", -1)
        assert st.rungs == {} and st.decisions == {}

    def test_below_eta_never_stops_but_records(self):
        st = MultiFidelityState(ASHAConfig(r_min=2, eta=3, max_rungs=2))
        assert st.report_rung(0, 2, 9.0) == ("continue", 0)
        assert st.report_rung(1, 2, 8.0) == ("continue", 0)
        assert st.value_at(0, 0) == 9.0 and st.value_at(1, 0) == 8.0
        assert st.report_rung(2, 2, 10.0) == ("stop", 0)

    def test_quantile_stop_top_survives(self):
        st = MultiFidelityState(ASHAConfig(r_min=1, eta=3, max_rungs=1))
        for tid, v in enumerate([1.0, 2.0, 3.0]):
            st.report_rung(tid, 1, v)
        assert st.report_rung(3, 1, 0.5) == ("continue", 0)
        assert st.report_rung(4, 1, 9.0) == ("stop", 0)

    def test_idempotent_rerecord_and_memoized_decision(self):
        st = MultiFidelityState(ASHAConfig(r_min=1, eta=2, max_rungs=1))
        assert st.report_rung(0, 1, 5.0) == ("continue", 0)
        assert st.report_rung(1, 1, 1.0) == ("continue", 0)
        assert st.report_rung(0, 1, 5.0) == ("continue", 0)
        assert len(st.rungs[0]) == 2

    def test_num_active_rungs(self):
        st = MultiFidelityState(ASHAConfig(r_min=1, eta=2, max_rungs=3))
        assert st.num_active_rungs() == 0
        st.report_rung(0, 1, 1.0)
        assert st.num_active_rungs() == 1
        st.report_rung(0, 4, 0.9)
        assert st.num_active_rungs() == 3

    def test_report_stream_and_snapshot_twin(self):
        """A seeded report stream gives the same decisions in both packages;
        each package's snapshot restores in the other and replays alike."""
        rng = np.random.default_rng(1)
        cfg = dict(r_min=1, eta=2, max_rungs=3)
        js, ts = JMFS(JASHA(**cfg)), MultiFidelityState(ASHAConfig(**cfg))
        for _ in range(60):
            key, it, v = int(rng.integers(0, 12)), int(rng.integers(1, 6)), float(rng.random())
            assert ts.report_rung(key, it, v) == js.report_rung(key, it, v)
        assert ts.num_active_rungs() == js.num_active_rungs()
        assert ts.promotion() == js.promotion()
        for src, dst_cls in ((js, MultiFidelityState), (ts, JMFS)):
            snap = json.loads(json.dumps(src.snapshot()))
            dst = dst_cls(dst_cls.config_from_wire(snap["config"]))
            dst.load_snapshot(snap)
            assert dst.promotion() == src.promotion()
            assert dst.report_rung(3, 2, 0.5) == src.report_rung(3, 2, 0.5)


# ----------------------------------------------------------- rung heads


def _store(C, n=5):
    space = _space(C)
    store = C.ObservationStore(space)
    for i, c in enumerate(space.sample(np.random.default_rng(0), n)):
        store.push(c, float(i + 1), key=i)
    return store


class TestRungHeads:
    def test_targets_impute_and_zscore_twin(self):
        ts, js = _store(T), _store(J)
        _, y_std, _, _ = ts.standardized()
        rungs = {0: {0: 10.0, 2: 20.0, 4: 30.0}, 1: {1: 42.0}}
        t = TPR.rung_head_targets(ts, rungs, 2, y_std)
        assert t.shape == (2, 5)
        np.testing.assert_allclose(t[0, [1, 3]], y_std[[1, 3]])
        v = np.asarray([10.0, 20.0, 30.0])
        np.testing.assert_allclose(t[0, [0, 2, 4]], (v - v.mean()) / v.std())
        assert t[1, 1] == 0.0  # a single observation z-scores to 0
        np.testing.assert_array_equal(
            t, JPR.rung_head_targets(js, rungs, 2, js.standardized()[1]))

    def test_weights_row_twin(self):
        w = TPR.rung_head_weights([1, 3, 9], 3)
        assert w.shape == (1, 4) and w[0, 0] == 0.5
        np.testing.assert_allclose(w.sum(), 1.0)
        np.testing.assert_allclose(w[0, 1:] / w[0, 1], [1.0, 3.0, 9.0])
        for r in range(4):
            np.testing.assert_array_equal(TPR.rung_head_weights([1, 3, 9], r),
                                          JPR.rung_head_weights([1, 3, 9], r))

    def test_rung_weighted_ei_twin(self):
        rng = np.random.default_rng(3)
        mu = rng.standard_normal((4, 3, 50))
        var = rng.random((4, 50)) + 1e-3
        yb = rng.standard_normal(3)
        w = np.asarray([0.5, 0.1, 0.4])
        got = TPR.rung_weighted_ei(*(torch.as_tensor(a) for a in (mu, var, yb, w)))
        want = JPR.rung_weighted_ei(*(jnp.asarray(a) for a in (mu, var, yb, w)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


# -------------------------------------------- in-service ASHA, end to end


def test_in_service_asha_tuner_twin():
    """The same multi-fidelity job in both packages: the trial tables, the
    stopped trials and the rung and decision tables agree; the rung-aware
    decision (``_decide_rungs``) runs once rung tables hold data."""
    jsvc, tsvc = _svc("jax"), _svc("torch")
    res_j = _make("jax", jsvc).run()
    tuner = _make("torch", tsvc)
    calls = []
    inner = tuner.suggester._decide_rungs

    def counted(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)

    tuner.suggester._decide_rungs = counted
    res_t = tuner.run()
    assert_same_tables(res_t, res_j)
    tp, jp = _promo(tsvc.job("mf-job")), _promo(jsvc.job("mf-job"))
    assert tp["decisions"] == jp["decisions"] and tp["rung_grid"] == jp["rung_grid"]
    assert tp["rungs"].keys() == jp["rungs"].keys()
    for r in tp["rungs"]:  # the same trials at each rung, values to 1e-9
        assert [k for k, _ in tp["rungs"][r]] == [k for k, _ in jp["rungs"][r]]
        np.testing.assert_allclose([v for _, v in tp["rungs"][r]],
                                   [v for _, v in jp["rungs"][r]], rtol=0, atol=1e-9)
    assert calls and any(t.state == TrialState.STOPPED for t in res_t.trials)


def test_stops_early_and_saves_resource():
    svc = _svc("torch")
    res = _make("torch", svc).run()
    base = _make("torch", _svc("torch"), mf=None).run()
    stopped = [t for t in res.trials if t.state == TrialState.STOPPED]
    assert stopped and res.num_early_stopped == len(stopped)
    assert sum(len(t.curve) for t in res.trials) < sum(len(t.curve) for t in base.trials)
    promo = svc.job("mf-job").promotion()
    assert promo["rung_grid"] == rung_iters(_mf(T))
    assert promo["rungs"] and promo["decisions"]
    assert len([d for d in promo["decisions"].values() if d == "stop"]) >= len(stopped)


def test_empty_rung_tables_bit_identical_to_off():
    tall = ASHAConfig(r_min=100, eta=3, max_rungs=2)
    got = _make("torch", _svc("torch"), mf=tall).run()
    ref = _make("torch", _svc("torch"), mf=None).run()
    assert _table(got) == _table(ref)


def test_validation():
    with pytest.raises(ValueError, match="service"):
        T.Tuner(_space(), _curve, None, TSim(),
                T.TuningJobConfig(max_trials=2, multi_fidelity=_mf(T)))
    svc = _svc("torch")
    with pytest.raises(ValueError, match="stopping_rule"):
        T.Tuner(_space(), _curve, None, TSim(),
                T.TuningJobConfig(max_trials=2, multi_fidelity=_mf(T)),
                stopping_rule=MedianRule(), service=svc)
    with pytest.raises(ValueError, match="single-metric"):
        T.Tuner(_space(), _curve, None, TSim(),
                T.TuningJobConfig(max_trials=2, multi_fidelity=_mf(T),
                                  metrics=(MetricSpec("loss"),
                                           MetricSpec("lat", objective=False,
                                                      threshold=1.0))),
                service=svc)


def test_maximize_goal_signs_rung_values():
    def objective(cfg):
        reward = 10.0 - _floor(cfg)
        return reward * (1.0 - np.exp(-0.3 * np.arange(1, 28))), 1.0, {"reward": reward}

    svc = _svc("torch")
    res = T.Tuner(_space(), objective, None, TSim(),
                  T.TuningJobConfig(max_trials=10, job_name="mf-max", seed=3,
                                    metrics=(MetricSpec("reward", goal="maximize"),),
                                    multi_fidelity=_mf(T)),
                  service=svc).run()
    vals = [v for table in svc.job("mf-max").promotion()["rungs"].values() for _, v in table]
    assert vals and all(v < 0 for v in vals)
    completed = [t for t in res.trials if t.state == TrialState.COMPLETED]
    assert completed and any(t.state == TrialState.STOPPED for t in res.trials)
    assert res.best_trial.metrics["reward"] == max(t.metrics["reward"] for t in completed)
    assert res.best_trial.state == TrialState.COMPLETED


def test_minimize_goal_rung_values_raw():
    svc = _svc("torch")
    _make("torch", svc).run()
    vals = [v for table in svc.job("mf-job").promotion()["rungs"].values() for _, v in table]
    assert vals and all(v > 0 for v in vals)


def test_checkpoint_kill_restore_exact(tmp_path):
    """Crash with ASHA active, restore from the checkpoint file, finish: the
    trial table and the rung and decision tables match the uninterrupted
    run (the rung state rides the suggester's state dict)."""
    ref_svc = _svc("torch", share_gphp=False)
    ref = _make("torch", ref_svc).run()

    class _Crash(Exception):
        pass

    def boom(tuner, trial):
        if sum(1 for t in tuner.trials.values() if t.is_terminal) == 4:
            raise _Crash()

    path = str(tmp_path / "mf.json")
    svc = _svc("torch", share_gphp=False)
    with pytest.raises(_Crash):
        _make("torch", svc, path=path, callbacks=[boom]).run()
    t2 = _make("torch", svc, path=path)
    t2.restore()
    assert _table(t2.run()) == _table(ref)
    assert svc.job("mf-job").promotion() == ref_svc.job("mf-job").promotion()


def test_jax_multifidelity_state_dict_loads_into_port():
    """A JAX multi-fidelity engine's ``state_dict`` (rung tables included)
    loads into the port's engine, and the next rung-aware decisions match."""
    jsvc, tsvc = _svc("jax", share_gphp=False), _svc("torch", share_gphp=False)
    jres = _make("jax", jsvc, max_trials=8).run()
    jh = jsvc.job("mf-job")
    assert jh.multi_fidelity.num_active_rungs() > 0
    state = json.loads(json.dumps(jh.suggester.state_dict()))
    assert state["multi_fidelity"] is not None

    th = tsvc.register_job("mf-job", _space(), bo_config=T.BOConfig(num_init=3).fast(),
                           seed=3, multi_fidelity=_mf(T))
    th.store.load_snapshot(json.loads(json.dumps(jh.store.snapshot())))
    th.suggester.load_state_dict(state)
    assert th.promotion() == jh.promotion()
    space = _space()
    for _ in range(2):
        want, got = jh.suggest_batch(2), th.suggest_batch(2)
        np.testing.assert_allclose(space.encode_batch(got), space.encode_batch(want),
                                   rtol=0, atol=1e-9)
        for c in want:
            y = float(_curve(c)[0][-1])
            jh.store.push(c, y)
            th.store.push(c, y)
    assert len(jres.trials) == 8
