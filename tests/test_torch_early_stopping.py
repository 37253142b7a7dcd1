"""The port's early stopping, blackbox harness, MAP-II fit and quality gates
against the JAX package's.

* ``MedianRule`` and ``ASHARule`` / ``SynchronousHyperband`` are numpy-only
  copies: the reference's semantics tests run on the port, and the same
  report streams give the same decisions and state dicts in both packages.
* A ``Tuner`` with either rule on ``SimBackend`` makes the JAX package's
  decisions and stops the same trials (tables to 1e-9); killed mid-job and
  restored from its checkpoint file, it reproduces the uninterrupted run,
  the rule's tables included.
* ``BlackboxTable`` / ``TabulatedBackend``: the synthetic tables are equal
  and a table's JSON written by either package loads into the other.
* ``map_gphps`` holds the reference's ``backend="xla"`` MAP estimate to
  1e-8 over 5 seeds (measured gap 6.2e-12); a ``BOSuggester`` with
  ``gphp_method="map"`` gives the reference's trial table to 1e-9.
* The reference's three quality gates (``tests/test_quality_gate.py``) pass
  on the port, and its BO runs there equal the reference's to 1e-9.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core.asha import HyperbandConfig as JHBC
from repro.core.asha import SynchronousHyperband as JHB
from repro.core.blackbox import BlackboxTable as JBT
from repro.core.blackbox import TabulatedBackend as JTB
from repro.core.blackbox import deceptive_cheap_table as j_deceptive
from repro.core.blackbox import quadratic_table as j_quadratic
from repro.core.gp import fit as JF
from repro.core.gp import params as JP
from repro.core.gp.slice_sampler import SliceSamplerConfig as JSC
from repro.core.optimize_acq import AcqOptConfig as JAcq
from repro.core.scheduler import SimBackend as JSim
import repro_torch.core as T
from repro_torch.core import prng
from repro_torch.core.asha import HyperbandConfig, SynchronousHyperband
from repro_torch.core.blackbox import (
    BlackboxTable,
    TabulatedBackend,
    deceptive_cheap_table,
    quadratic_table,
)
from repro_torch.core.gp import fit as TF
from repro_torch.core.gp import params as TP
from repro_torch.core.gp.empirical_bayes import _bias_corrections
from repro_torch.core.gp.slice_sampler import SliceSamplerConfig as TSC
from repro_torch.core.optimize_acq import AcqOptConfig as TAcq
from repro_torch.core.scheduler import SimBackend as TSim
from repro_torch.core.trial import TrialState

torch.backends.cuda.matmul.allow_tf32 = False
# pytest-xdist runs the suite in several worker processes; torch's default
# thread pool in each of them oversubscribes the CPU, and these twins (many
# small ops) then run ~10x slower
torch.set_num_threads(1)

TINY = dict(num_samples=12, burn_in=6, thin=2)
SMALL_ACQ = dict(num_anchors=128, num_refine=4, refine_steps=5)

PKG = {
    "jax": dict(C=J, SC=JSC, Acq=JAcq, Sim=JSim, TB=JTB, kw={}),
    "torch": dict(C=T, SC=TSC, Acq=TAcq, Sim=TSim, TB=TabulatedBackend,
                  kw={"device": "cpu"}),
}


def _curve(floor, n=20, seed=0):
    rng = np.random.default_rng(seed)
    return floor + 2.0 * np.exp(-0.4 * np.arange(1, n + 1)) + 0.01 * rng.standard_normal(n)


# --------------------------------------------------------- the rules alone


class TestMedianRule:
    def test_inactive_without_completed_curves(self):
        assert not T.MedianRule().should_stop(_curve(10.0))

    def test_stops_bad_keeps_good(self):
        rule = T.MedianRule(T.MedianRuleConfig(min_completed_curves=3))
        for s in range(4):
            rule.record_completed(_curve(1.0 + 0.05 * s, seed=s))
        assert rule.should_stop(_curve(5.0, n=10, seed=9))
        assert not rule.should_stop(_curve(0.5, n=10, seed=10))

    def test_dynamic_activation_threshold(self):
        rule = T.MedianRule(T.MedianRuleConfig(min_completed_curves=1,
                                               min_iteration_fraction=0.25))
        rule.record_completed(_curve(1.0, n=40))
        assert rule.activation_iteration() == 10
        assert not rule.should_stop(_curve(9.0, n=5))
        assert rule.should_stop(_curve(9.0, n=10))

    def test_median_semantics_exact(self):
        rule = T.MedianRule(T.MedianRuleConfig(min_completed_curves=3,
                                               min_iteration_fraction=0.0,
                                               min_iteration_floor=1))
        for v in (1.0, 2.0, 3.0):
            rule.record_completed([v] * 4)
        assert rule.should_stop([2.5])
        assert not rule.should_stop([1.5])

    def test_state_roundtrip(self):
        rule = T.MedianRule()
        rule.record_completed(_curve(1.0))
        rule2 = T.MedianRule()
        rule2.load_state_dict(rule.state_dict())
        assert rule2.num_completed == 1


class TestASHA:
    def test_promotion_at_rungs_only(self):
        rule = T.ASHARule(T.ASHAConfig(r_min=2, eta=2))
        assert not rule.should_stop([9.0])
        assert not rule.should_stop([9.0, 9.0, 9.0])

    def test_bottom_half_stopped(self):
        rule = T.ASHARule(T.ASHAConfig(r_min=1, eta=2))
        for v in (1.0, 2.0, 3.0, 4.0):
            rule.record_completed([v] * 8)
        assert rule.should_stop([10.0])
        assert not rule.should_stop([0.5])

    def test_state_roundtrip(self):
        rule = T.ASHARule()
        rule.record_completed([1.0, 0.5, 0.2])
        r2 = T.ASHARule()
        r2.load_state_dict(rule.state_dict())
        assert r2._rungs == rule._rungs


class TestHyperband:
    def test_bracket_ladder_twin(self):
        hb = SynchronousHyperband(HyperbandConfig(r_max=27, eta=3))
        brackets = hb.brackets()
        assert len(brackets) == 4
        assert brackets[0][0] == {"n": 27, "r": 1}
        assert brackets[0][-1]["r"] == 27
        assert brackets[-1][0]["r"] == 27
        assert brackets == JHB(JHBC(r_max=27, eta=3)).brackets()

    def test_promotion_twin(self):
        vals = [5.0, 1.0, 3.0, 2.0, 4.0, 0.5]
        assert SynchronousHyperband.promote(vals, 3) == [5, 1]
        assert SynchronousHyperband.promote(vals, 3) == JHB.promote(vals, 3)


RULES = {
    "median": (lambda C: C.MedianRule(C.MedianRuleConfig(min_completed_curves=2))),
    "asha": (lambda C: C.ASHARule(C.ASHAConfig(r_min=2, eta=2, max_rungs=3))),
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_decisions_and_state_twin(rule):
    """A seeded stream of keyed completions and running curves: the same
    decisions at every report and the same state dict."""
    rng = np.random.default_rng(4)
    jr, tr = RULES[rule](J), RULES[rule](T)
    for trial in range(30):
        curve = _curve(rng.random() * 3.0, n=int(rng.integers(1, 16)), seed=trial)
        for r in range(1, len(curve) + 1):
            assert tr.should_stop(curve[:r], trial_id=trial) == \
                jr.should_stop(curve[:r], trial_id=trial)
        if rng.random() < 0.6:
            tr.record_completed(curve, trial_id=trial)
            jr.record_completed(curve, trial_id=trial)
    assert json.loads(json.dumps(tr.state_dict())) == json.loads(json.dumps(jr.state_dict()))


# --------------------------------------------- rules inside the Tuner, twin


def space_of(C):
    return C.SearchSpace([
        C.Continuous("lr", 1e-4, 1.0, scaling="log"),
        C.Continuous("wd", 1e-5, 1e-1, scaling="log"),
    ])


def _floor(cfg):
    return (math.log10(cfg["lr"]) + 2) ** 2 + (math.log10(cfg["wd"]) + 3) ** 2


def _curve_objective(cfg, n=8, cost=1.0):
    return _floor(cfg) + 3.0 * np.exp(-0.5 * np.arange(1, n + 1)), cost


class _CrashAfter(Exception):
    pass


def _crash_after(n):
    done = {"n": 0}

    def boom(tuner, trial):
        done["n"] += 1
        if done["n"] == n:
            raise _CrashAfter()

    return [boom]


def _fast(C, **over):
    return C.BOConfig(num_init=2, refit_every=2, **over).fast()


def _rule_tuner(pkg, rule, path=None, crash_after=None, seed=17):
    p = PKG[pkg]
    C = p["C"]
    sugg = C.BOSuggester(space_of(C), _fast(C), seed=seed, **p["kw"])
    return C.Tuner(
        space_of(C), _curve_objective, sugg, p["Sim"](),
        C.TuningJobConfig(max_trials=8, checkpoint_path=path),
        stopping_rule=RULES[rule](C),
        callbacks=_crash_after(crash_after) if crash_after else (),
    )


def _stops(result):
    return [(t.trial_id, t.state, t.stopped_early, len(t.curve)) for t in result.trials]


def assert_same_tables(res_t, res_j, space, atol=1e-9):
    assert len(res_t.trials) == len(res_j.trials)
    enc_t = np.stack([space.encode(t.config) for t in res_t.trials])
    enc_j = np.stack([space.encode(t.config) for t in res_j.trials])
    np.testing.assert_allclose(enc_t, enc_j, rtol=0, atol=atol)
    for a, b in zip(res_t.trials, res_j.trials):
        assert a.objective == pytest.approx(b.objective, abs=atol)


@pytest.mark.parametrize("rule", sorted(RULES))
def test_stopping_rule_tuner_twin(rule):
    res_j = _rule_tuner("jax", rule).run()
    tuner = _rule_tuner("torch", rule)
    res_t = tuner.run()
    assert_same_tables(res_t, res_j, space_of(T))
    assert [(i, str(s), e, n) for i, s, e, n in _stops(res_t)] == \
        [(i, str(s), e, n) for i, s, e, n in _stops(res_j)]
    assert res_t.num_early_stopped >= 1
    # the Tuner keys both rules by trial id, as the reference's does
    assert tuner._rule_stop_keyed and tuner._rule_rec_keyed


@pytest.mark.parametrize("rule", sorted(RULES))
def test_stopping_rule_kill_restore_matches_uninterrupted(tmp_path, rule):
    """The reference's ``TestStoppingRuleRestoreEquivalence`` on the port:
    replayed crossings and completions overwrite instead of double-counting,
    so crash + restore reproduces the uninterrupted run and the rule's
    tables."""
    tuner_a = _rule_tuner("torch", rule, str(tmp_path / "a.json"))
    res_a = tuner_a.run()
    p_b = str(tmp_path / "b.json")
    with pytest.raises(_CrashAfter):
        _rule_tuner("torch", rule, p_b, crash_after=4).run()
    tuner_b = _rule_tuner("torch", rule, p_b)
    tuner_b.restore()
    res_b = tuner_b.run()
    assert _stops(res_a) == _stops(res_b)
    for ta, tb in zip(res_a.trials, res_b.trials):
        assert ta.objective == pytest.approx(tb.objective, abs=1e-6)
    sa = json.loads(json.dumps(tuner_a.stopping_rule.state_dict()))
    sb = json.loads(json.dumps(tuner_b.stopping_rule.state_dict()))
    assert sa == sb


def _file_tuner(path, seed=11, crash_after=None):
    sugg = T.BOSuggester(space_of(T), _fast(T), seed=seed, device="cpu")
    return T.Tuner(space_of(T), lambda c: _curve_objective(c, n=6), sugg, TSim(),
                   T.TuningJobConfig(max_trials=7, checkpoint_path=path),
                   callbacks=_crash_after(crash_after) if crash_after else ())


def test_file_checkpoint_kill_restore_matches_uninterrupted(tmp_path):
    """The reference's ``TestKillRestoreEquivalence`` on the port, through
    a checkpoint file: the trial table, the store's push order and the next
    suggestion all match the uninterrupted run."""
    space = space_of(T)
    tuner_a = _file_tuner(str(tmp_path / "a.json"))
    res_a = tuner_a.run()
    p_b = str(tmp_path / "b.json")
    with pytest.raises(_CrashAfter):
        _file_tuner(p_b, crash_after=3).run()
    tuner_b = _file_tuner(p_b)
    tuner_b.restore()
    res_b = tuner_b.run()
    assert len(res_a.trials) == len(res_b.trials)
    for ta, tb in zip(res_a.trials, res_b.trials):
        assert (ta.trial_id, ta.state, ta.attempts) == (tb.trial_id, tb.state, tb.attempts)
        np.testing.assert_allclose(space.encode(ta.config), space.encode(tb.config),
                                   atol=1e-6)
        assert ta.objective == pytest.approx(tb.objective, abs=1e-6)
    sa, sb = tuner_a.store.state_dict(), tuner_b.store.state_dict()
    np.testing.assert_allclose(sa["own_x"], sb["own_x"], atol=1e-6)
    np.testing.assert_allclose(sa["own_y"], sb["own_y"], atol=1e-6)
    np.testing.assert_allclose(space.encode(tuner_a.suggester.suggest_batch(1)[0]),
                               space.encode(tuner_b.suggester.suggest_batch(1)[0]),
                               atol=1e-6)


def test_crash_restore_does_not_consume_retry_budget(tmp_path):
    path = str(tmp_path / "t.json")

    def fresh():
        return T.Tuner(space_of(T), _curve_objective, T.RandomSuggester(space_of(T), seed=5),
                       TSim(), T.TuningJobConfig(max_trials=3, max_retries=1,
                                                 checkpoint_path=path))

    tuner = fresh()
    tuner._refill_slots()
    tuner.save()
    for _ in range(3):
        tuner = fresh()
        tuner.restore()
        tuner._requeue_retries()
        tuner.save()
    res = tuner.run()
    assert all(t.state == TrialState.COMPLETED for t in res.trials)
    assert next(t for t in res.trials if t.trial_id == 0).attempts == 1
    assert res.num_failed_attempts == 0


def _cost_tuner(pkg, path=None, crash_after=None, seed=3):
    p = PKG[pkg]
    C = p["C"]
    table = (deceptive_cheap_table if pkg == "torch" else j_deceptive)()
    sugg = C.BOSuggester(table.space, _fast(C, cost_aware=True, cost_cooling=2.0),
                         seed=seed, **p["kw"])
    return C.Tuner(
        table.space, table.objective, sugg, p["TB"](table, startup_cost=0.05),
        C.TuningJobConfig(max_trials=12, max_parallel=2, seed=seed, max_cost=40.0,
                          checkpoint_path=path, job_name="cost-restore"),
        callbacks=_crash_after(crash_after) if crash_after else (),
    )


def test_cost_aware_blackbox_twin_and_kill_restore(tmp_path):
    """The reference's ``TestCostAwareRestoreEquivalence`` on the port: a
    cost-aware job on the deceptive table under ``max_cost`` gives the JAX
    package's table and spend, and killed mid-spend and restored it
    reproduces the uninterrupted table and ledger."""
    res_j = _cost_tuner("jax").run()
    tuner_a = _cost_tuner("torch", str(tmp_path / "a.json"))
    res_a = tuner_a.run()
    assert_same_tables(res_a, res_j, tuner_a.space)
    assert tuner_a.budget_ledger.spent > 0.0

    p_b = str(tmp_path / "b.json")
    tuner_b = _cost_tuner("torch", p_b, crash_after=3)
    with pytest.raises(_CrashAfter):
        tuner_b.run()
    assert 0.0 < tuner_b.budget_ledger.spent < tuner_a.budget_ledger.spent
    tuner_b2 = _cost_tuner("torch", p_b)
    tuner_b2.restore()
    assert 0.0 < tuner_b2.budget_ledger.spent <= tuner_b.budget_ledger.spent
    res_b = tuner_b2.run()
    for ta, tb in zip(res_a.trials, res_b.trials):
        assert (ta.trial_id, ta.state, ta.attempts) == (tb.trial_id, tb.state, tb.attempts)
        np.testing.assert_allclose(tuner_a.space.encode(ta.config),
                                   tuner_a.space.encode(tb.config), atol=1e-6)
        assert ta.objective == pytest.approx(tb.objective, abs=1e-9)
    assert tuner_b2.budget_ledger.spent == pytest.approx(tuner_a.budget_ledger.spent, abs=1e-9)
    assert tuner_b2.budget_ledger.max_cost == 40.0


# ------------------------------------------------------------- blackbox


@pytest.mark.parametrize("make", ["quadratic", "deceptive"])
def test_blackbox_tables_twin_and_json_crosses_packages(make):
    t_tab = {"quadratic": quadratic_table, "deceptive": deceptive_cheap_table}[make]()
    j_tab = {"quadratic": j_quadratic, "deceptive": j_deceptive}[make]()
    np.testing.assert_array_equal(t_tab.grid, j_tab.grid)
    np.testing.assert_array_equal(t_tab.curves, j_tab.curves)
    np.testing.assert_array_equal(t_tab.costs, j_tab.costs)
    assert t_tab.best_value() == j_tab.best_value()
    assert t_tab.to_json() == j_tab.to_json()
    # a JSON written by one package loads into the other
    back_t, back_j = BlackboxTable.from_json(j_tab.to_json()), JBT.from_json(t_tab.to_json())
    np.testing.assert_array_equal(back_t.curves, j_tab.curves)
    np.testing.assert_array_equal(back_j.costs, t_tab.costs)
    rng = np.random.default_rng(0)
    for cfg in t_tab.space.sample(rng, 5):
        assert t_tab.lookup(cfg) == j_tab.lookup(cfg)
        assert t_tab.objective(cfg) == j_tab.objective(cfg)


# ---------------------------------------------------------------- MAP-II


def test_bias_corrections_are_the_reference_float32_steps():
    steps = jnp.arange(150, dtype=jnp.float32)
    for beta in (0.9, 0.999):
        want = np.asarray(jax.jit(lambda i: 1.0 - beta ** (i + 1.0))(steps))
        np.testing.assert_array_equal(_bias_corrections(150, beta), want.astype(np.float64))


@pytest.mark.parametrize("seed", range(5))
def test_map_gphps_twin(seed):
    """The MAP estimate against ``repro.core.gp.fit.map_gphps(...,
    backend="xla")`` on the same rows and key (the reference's Pallas route
    cannot be differentiated). 150 Adam steps over 4 restarts; measured gap
    6.2e-12 at worst over these seeds, held at 1e-8."""
    rng = np.random.default_rng(seed)
    n, nb, d = 9, 16, 3
    x = np.zeros((nb, d))
    x[:n] = rng.random((n, d))
    y = np.zeros(nb)
    y[:n] = rng.standard_normal(n)
    mask = np.arange(nb) < n
    jb = JP.default_bounds(d, list(range(d)))
    tb = TP.default_bounds(d, list(range(d)))
    init = np.clip(np.asarray(JP.default_params(d).pack()), jb.lower + 1e-4, jb.upper - 1e-4)
    want = np.asarray(JF.map_gphps(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), jb,
                                   jnp.asarray(init), jax.random.PRNGKey(seed), backend="xla"))
    got = TF.map_gphps(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(mask), tb,
                       init, prng.PRNGKey(seed))
    assert got.shape == want.shape == (3 * d + 2,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


def test_map_kernel_backend_refuses_before_any_work():
    with pytest.raises(ValueError, match="no backward"):
        TF.map_gphps(torch.zeros(8, 2, dtype=torch.float64), torch.zeros(8, dtype=torch.float64),
                     torch.ones(8, dtype=torch.bool), TP.default_bounds(2, [0, 1]),
                     np.zeros(8), prng.PRNGKey(0), backend="kernel")


def _map_tuner(pkg, trials=9):
    p = PKG[pkg]
    C = p["C"]
    space = space_of(C)
    cfg = C.BOConfig(num_init=3, gphp_method="map", refit_every=2,
                     acq=p["Acq"](**SMALL_ACQ))
    sugg = C.BOSuggester(space, cfg, seed=2, **p["kw"])
    return C.Tuner(space, _curve_objective, sugg, p["Sim"](),
                   C.TuningJobConfig(max_trials=trials, max_parallel=2))


def test_map_suggester_tuner_twin():
    res_j = _map_tuner("jax").run()
    tuner = _map_tuner("torch")
    res_t = tuner.run()
    assert_same_tables(res_t, res_j, space_of(T))
    assert tuner.suggester.cache.samples.shape[0] == 1


# --------------------------------------------------------- quality gates


def _gate_config(C, SC, cost_aware=False):
    return C.BOConfig(num_init=6, slice_config=SC(**TINY), refit_every=3,
                      incremental=True, cost_aware=cost_aware, cost_cooling=2.0)


class _Random:
    def __init__(self, space, seed):
        self.space = space
        self._rng = np.random.default_rng(seed)

    def suggest_batch(self, k):
        return self.space.sample(self._rng, k)


def _gate_run(pkg, table, suggester, seed, max_trials=20):
    p = PKG[pkg]
    backend = p["TB"](table, startup_cost=0.05)
    result = p["C"].Tuner(
        table.space, table.objective, suggester, backend,
        p["C"].TuningJobConfig(max_trials=max_trials, max_parallel=2, seed=seed,
                               job_name=f"gate-{seed}"),
    ).run()
    assert backend.evaluations == max_trials
    return result, float(backend.now())


def test_bo_beats_random_on_quadratic():
    """The reference's gate on the port (mean best over seeds 0–2: BO <
    random and < 0.05), and the port's BO runs equal the reference's."""
    table, jtable = quadratic_table(), j_quadratic()
    bo, rand = [], []
    for s in (0, 1, 2):
        res, _ = _gate_run("torch", table, T.BOSuggester(
            table.space, _gate_config(T, TSC), seed=s, device="cpu"), s)
        bo.append(float(res.best_trial.objective))
        rand.append(float(_gate_run("torch", table, _Random(table.space, s), s)[0]
                          .best_trial.objective))
        if s == 0:
            ref, _ = _gate_run("jax", jtable, J.BOSuggester(
                jtable.space, _gate_config(J, JSC), seed=s), s)
            assert_same_tables(res, ref, table.space)
    assert np.mean(bo) < np.mean(rand), (bo, rand)
    assert np.mean(bo) < 0.05, bo


def test_cost_aware_matches_ei_at_lower_spend():
    table = deceptive_cheap_table()
    span = abs(table.best_value())
    ei, eipu = [], []
    for s in (0, 1):
        for out, ca in ((ei, False), (eipu, True)):
            res, cost = _gate_run("torch", table, T.BOSuggester(
                table.space, _gate_config(T, TSC, cost_aware=ca), seed=s, device="cpu"), s)
            out.append((float(res.best_trial.objective), cost))
    ei_best = float(np.mean([b for b, _ in ei]))
    pu_best = float(np.mean([b for b, _ in eipu]))
    assert pu_best <= ei_best + 0.05 * span, (ei, eipu)
    assert np.mean([c for _, c in eipu]) < np.mean([c for _, c in ei]), (ei, eipu)
    assert ei_best < -0.5 and pu_best < -0.5, (ei, eipu)


def test_deceptive_table_cost_contrast():
    table = deceptive_cheap_table()
    cheap = table.lookup({"x": 0.2, "y": 0.2})
    exp = table.lookup({"x": 0.8, "y": 0.8})
    assert table.curves[cheap, -1] < table.curves[exp, -1] < -0.8
    assert table.total_cost(exp) > 8.0 * table.total_cost(cheap)
    assert table.best_value() == pytest.approx(float(table.curves[cheap, -1]), abs=0.05)
