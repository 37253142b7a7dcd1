"""The port's cost-aware decisions and budgets against the JAX package's.

* ``BudgetLedger`` is a numpy-free copy: the same charges give the same
  spend, exhaustion, refusals and snapshots.
* The ``cost`` mode of ``acq_score_multi`` with η = 0 is plain EI on the
  objective head (1e-12: the discount factor is exactly 1).
* A cost-aware ``Tuner`` with ``max_cost`` on ``SimBackend`` makes the JAX
  package's decisions (``backend="pallas"`` there, the fused ``"kernel"``
  scoring on ``device="cpu"`` here): trial tables to 1e-9, the same spend
  and the same last launched trial.
* A JAX cost-aware ``state_dict`` with its ``"budget"`` key loads into the
  port, and the next decisions match.
"""

import json
import math

import numpy as np
import pytest
import torch

import repro.core as J
from repro.core.budget import BudgetExhaustedError as JExhausted
from repro.core.budget import BudgetLedger as JLedger
from repro.core.gp.slice_sampler import SliceSamplerConfig as JSC
from repro.core.optimize_acq import AcqOptConfig as JAcq
from repro.core.scheduler import SimBackend as JSim
import repro_torch.core as T
from repro_torch.core.gp import gp as TG
from repro_torch.core.gp import multi as TM
from repro_torch.core.gp import params as TP
from repro_torch.core.gp.slice_sampler import SliceSamplerConfig as TSC
from repro_torch.core.optimize_acq import AcqOptConfig as TAcq
from repro_torch.core.optimize_acq import MultiMetricHead
from repro_torch.core.scheduler import SimBackend as TSim
from repro_torch.kernels.acq_score.ops import acq_score, acq_score_multi

torch.backends.cuda.matmul.allow_tf32 = False

TINY = dict(num_samples=12, burn_in=6, thin=2)
SMALL_ACQ = dict(num_anchors=128, num_refine=4, refine_steps=5)

PKG = {
    "jax": dict(C=J, SC=JSC, Acq=JAcq, Sim=JSim, backend="pallas", kw={}),
    "torch": dict(C=T, SC=TSC, Acq=TAcq, Sim=TSim, backend="kernel",
                  kw={"device": "cpu"}),
}


def t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


# ------------------------------------------------------------------ ledger


def test_budget_ledger_twin():
    rng = np.random.default_rng(0)
    charges = list(rng.random(12) * 3.0) + [-1.0, 0.0, float("nan"), float("inf")]
    for cap in (10.0, None):
        jl, tl = JLedger(cap), T.BudgetLedger(cap)
        for c in charges:
            assert tl.charge(c) == jl.charge(c)
            assert (tl.exhausted, tl.remaining) == (jl.exhausted, jl.remaining)
        assert tl.snapshot() == jl.snapshot()
        fresh = T.BudgetLedger(None)
        fresh.load_snapshot(json.loads(json.dumps(jl.snapshot())))
        assert fresh.snapshot() == jl.snapshot()
    tl, jl = T.BudgetLedger(1.0), JLedger(1.0)
    tl.charge(2.0)
    jl.charge(2.0)
    with pytest.raises(T.BudgetExhaustedError) as got:
        tl.check("job")
    with pytest.raises(JExhausted) as want:
        jl.check("job")
    assert str(got.value) == str(want.value)
    assert (got.value.spent, got.value.max_cost) == (2.0, 1.0)


# ----------------------------------------------------------- cost mode


def test_cost_mode_eta_zero_is_plain_ei():
    rng = np.random.default_rng(5)
    n, nb, d, S = 24, 32, 3, 4
    x = np.zeros((nb, d))
    x[:n] = rng.random((n, d))
    mask = np.zeros(nb, dtype=bool)
    mask[:n] = True
    yh = np.zeros((2, nb))
    yh[:, :n] = np.sin(4.0 * x[:n] @ rng.standard_normal((d, 2))).T
    base = TP.default_params(d).pack().numpy()
    packed = np.stack([base + 0.1 * rng.standard_normal(3 * d + 2) for _ in range(S)])
    post = TG.fit_posterior_batch(t(x), t(yh[0]), TP.GPHyperParams.unpack(t(packed), d),
                                  t(mask, torch.bool), with_inverse=True)
    alphas = TM.solve_head_alphas(post, t(yh))
    xs = t(rng.random((128, d)))
    y_best = float(yh[0, :n].min())
    plain = acq_score(post, xs, y_best).numpy()
    for eta, zero_cost in ((0.0, False), (3.0, True)):
        a = alphas.clone()
        if zero_cost:  # uniform costs standardize to a zero head
            a[:, 1] = 0.0
        head = MultiMetricHead(alphas=a, t_std=t(np.zeros(0)), y_best=y_best,
                               has_feasible=True, weights=t([[eta]]),
                               y_best_w=t(np.zeros(1)))
        for backend in ("kernel", "torch"):
            got = acq_score_multi(post, head, xs, mode="cost", backend=backend).numpy()
            np.testing.assert_allclose(got, plain, rtol=0, atol=1e-12)


# ------------------------------------------------------------ tuner twins


def space_of(C):
    return C.SearchSpace([
        C.Continuous("lr", 1e-4, 1.0, scaling="log"),
        C.Continuous("x", 0.0, 1.0),
        C.Integer("k", 1, 6),
    ])


def loss_of(cfg):
    return ((math.log10(cfg["lr"]) + 2.0) ** 2 + (cfg["x"] - 0.3) ** 2
            + 0.1 * (cfg["k"] - 3) ** 2)


def objective(cfg):
    f = loss_of(cfg)
    # cost per iteration grows with k and x: the cheap region is k small
    return [f + 1.0, f + 0.5, f], 0.5 + 0.4 * cfg["k"] + cfg["x"]


def bo_config(pkg, **over):
    p = PKG[pkg]
    acq = p["Acq"](**over.pop("acq", SMALL_ACQ))
    return p["C"].BOConfig(slice_config=p["SC"](**TINY), acq=acq,
                           backend=p["backend"], cost_aware=True,
                           cost_cooling=2.0, **over)


def run_tuner(pkg, max_cost, trials=14, parallel=2, **over):
    p = PKG[pkg]
    space = space_of(p["C"])
    sugg = p["C"].BOSuggester(space, bo_config(pkg, **over), seed=0, **p["kw"])
    tuner = p["C"].Tuner(space, objective, sugg, p["Sim"](), p["C"].TuningJobConfig(
        max_trials=trials, max_parallel=parallel, max_cost=max_cost))
    res = tuner.run()
    return space, tuner, res


@pytest.mark.parametrize("pending", ["exclude", "liar"])
def test_cost_aware_tuner_twin_with_max_cost(pending, monkeypatch):
    cost_decisions = []
    decide_cost = T.BOSuggester._decide_cost

    def counted(self, *args):
        cost_decisions.append(args[1])
        return decide_cost(self, *args)

    monkeypatch.setattr(T.BOSuggester, "_decide_cost", counted)
    space, jt, res_j = run_tuner("jax", 40.0, pending_strategy=pending)
    _, tt, res_t = run_tuner("torch", 40.0, pending_strategy=pending)
    assert len(cost_decisions) >= 3  # the log-cost head scored these
    assert len(res_t.trials) == len(res_j.trials) < 14  # the budget stopped it
    assert all(tr.state == "COMPLETED" for tr in res_t.trials)
    enc_t = np.stack([space.encode(tr.config) for tr in res_t.trials])
    enc_j = np.stack([space.encode(tr.config) for tr in res_j.trials])
    np.testing.assert_allclose(enc_t, enc_j, rtol=0, atol=1e-9)
    assert [tr.config["k"] for tr in res_t.trials] == [tr.config["k"] for tr in res_j.trials]
    assert tt.budget_ledger.spent == pytest.approx(jt.budget_ledger.spent, abs=1e-9)
    assert tt.budget_ledger.exhausted and jt.budget_ledger.exhausted
    # bounded overspend: at most the trials in flight when the cap was hit
    worst = max(3 * (0.5 + 0.4 * tr.config["k"] + tr.config["x"]) for tr in res_t.trials)
    assert tt.budget_ledger.spent <= 40.0 + 2 * worst
    last_t, last_j = res_t.trials[-1], res_j.trials[-1]
    assert last_t.trial_id == last_j.trial_id
    np.testing.assert_allclose(space.encode(last_t.config), space.encode(last_j.config),
                               rtol=0, atol=1e-9)
    assert tt.suggester.state_dict()["budget"] == pytest.approx(
        jt.suggester.state_dict()["budget"])


def _store(C, space, rows):
    store = C.ObservationStore(space)
    for i, c in enumerate(rows):
        store.push(c, loss_of(c), key=i, cost=3 * objective(c)[1])
    return store


def test_jax_cost_state_dict_with_budget_loads_into_port():
    js, ts = space_of(J), space_of(T)
    rows = list(js.sample(np.random.default_rng(9), 6))
    jstore = _store(J, js, rows)
    jsugg = J.BOSuggester(js, bo_config("jax", refit_every=2), seed=4, store=jstore)
    jsugg.budget_ledger = JLedger(60.0)
    jsugg.budget_ledger.charge(sum(3 * objective(c)[1] for c in rows))
    for c in jsugg.suggest_batch(2):  # mid-job
        rows.append(c)
        jstore.push(c, loss_of(c), key=len(rows), cost=3 * objective(c)[1])
        jsugg.budget_ledger.charge(3 * objective(c)[1])
    state = json.loads(json.dumps(jsugg.state_dict()))
    assert state["budget"]["spent"] > 0.0

    tstore = _store(T, ts, rows)
    tsugg = T.BOSuggester(ts, bo_config("torch", refit_every=2), seed=4, store=tstore,
                          device="cpu")
    tsugg.budget_ledger = T.BudgetLedger(None)
    tsugg.load_state_dict(state)
    assert tsugg.budget_ledger.snapshot() == state["budget"]
    for _ in range(2):
        got, want = tsugg.suggest_batch(1), jsugg.suggest_batch(1)
        np.testing.assert_allclose(ts.encode_batch(got), js.encode_batch(want),
                                   rtol=0, atol=1e-9)
        for c in want:
            cost = 3 * objective(c)[1]
            jstore.push(c, loss_of(c), cost=cost)
            tstore.push(c, loss_of(c), cost=cost)
            jsugg.budget_ledger.charge(cost)
            tsugg.budget_ledger.charge(cost)
    assert tsugg.state_dict()["budget"] == jsugg.state_dict()["budget"]


def test_cost_aware_refusals_twin():
    """Both packages refuse cost-aware multi-metric stores and acq != "ei"
    at bind time, before any trial spends budget."""
    for pkg in ("jax", "torch"):
        C = PKG[pkg]["C"]
        space = space_of(C)
        store = C.ObservationStore(space, metrics=C.MetricSet(
            (C.MetricSpec("loss"), C.MetricSpec("lat", objective=False, threshold=1.0))))
        with pytest.raises(ValueError, match="single-metric"):
            C.BOSuggester(space, bo_config(pkg), seed=0, store=store, **PKG[pkg]["kw"])
        with pytest.raises(ValueError, match="acq='ei'"):
            C.BOSuggester(space, bo_config(pkg, acq=dict(SMALL_ACQ, acq="lcb")), seed=0,
                          store=C.ObservationStore(space), **PKG[pkg]["kw"])
        with pytest.raises(ValueError, match="cost_cooling"):
            C.BOConfig(cost_cooling=-1.0)
