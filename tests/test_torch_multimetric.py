"""The port's multi-metric layer against the JAX package's, on the same numpy
inputs.

* ``MetricSpec``/``MetricSet`` and ``pareto_mask``/``hypervolume`` are
  numpy copies: equal results.
* The closed-form acquisitions, ``solve_head_alphas`` and
  ``predict_heads`` agree to 1e-10 (both sides float64; the solves order
  their sums differently).
* ``acq_score_multi`` in all four modes: the port's kernel path on CPU
  tensors (its plain version) against the JAX oracle
  ``acq_score_multi_ref`` over n × S × d, and against the JAX Pallas
  kernel in interpret mode at one shape per mode, both to 1e-10 of
  max(1, max |score|): the cost mode's discount exp(−η μ_cost) reaches
  scores of order 10³, where float64 resolves ~1e-13 relative. The head
  targets are smooth functions of x, as metrics are; white-noise targets on
  n = 40 points in d = 2 make the gram so ill-conditioned that the
  reference's own oracle and Pallas kernel differ by 3e-8.
* Tuner twins on ``SimBackend``: constrained (M=2) and Pareto with a
  constraint (M=3) — JAX with ``backend="pallas"``, the port on
  ``device="cpu"`` with fused ``"kernel"`` scoring. Trial tables agree to
  1e-9 and the best-feasible trial and the Pareto front are the same
  trials. A JAX Pareto ``state_dict`` taken mid-job loads into the port.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core.gp import gp as JG
from repro.core.gp import multi as JM
from repro.core.gp import params as JP
from repro.core.gp.per_resource import rung_head_weights
from repro.core.gp.slice_sampler import SliceSamplerConfig as JSC
from repro.core.multimetric import acquisition as JMA
from repro.core.optimize_acq import AcqOptConfig as JAcq
from repro.core.optimize_acq import MultiMetricHead as JHead
from repro.core.scheduler import SimBackend as JSim
from repro.kernels.acq_score.ops import acq_score_multi as j_acq_score_multi
from repro.kernels.acq_score.ref import acq_score_multi_ref
import repro_torch.core as T
from repro_torch import kernels as K
from repro_torch.core.gp import gp as TG
from repro_torch.core.gp import multi as TM
from repro_torch.core.gp import params as TP
from repro_torch.core.gp.slice_sampler import SliceSamplerConfig as TSC
from repro_torch.core.multimetric import acquisition as TMA
from repro_torch.core.optimize_acq import AcqOptConfig as TAcq
from repro_torch.core.optimize_acq import MultiMetricHead as THead
from repro_torch.core.scheduler import SimBackend as TSim
from repro_torch.kernels.acq_score import kernel as acq_kernel_mod
from repro_torch.kernels.acq_score.kernel import acq_score_multi_kernel
from repro_torch.kernels.acq_score.ops import acq_score_multi, pack_multi_inputs

torch.backends.cuda.matmul.allow_tf32 = False

TINY = dict(num_samples=12, burn_in=6, thin=2)
SMALL_ACQ = dict(num_anchors=128, num_refine=4, refine_steps=5)
MODES = ["constrained", "pareto", "rungs", "cost"]
# the oracle runs op by op otherwise: ~2 s a call against ~0.3 s compiled
multi_ref = jax.jit(acq_score_multi_ref, static_argnames=("mode", "has_feasible"))


def t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


# ------------------------------------------------------------ specs, fronts


def test_metric_set_twin():
    for C in (J, T):
        with pytest.raises(ValueError):
            C.MetricSpec("m", threshold=1.0)
        with pytest.raises(ValueError):
            C.MetricSet([C.MetricSpec("c", objective=False, threshold=1.0)])
    specs = [("acc", "maximize", True, None), ("loss", "minimize", True, None),
             ("lat", "minimize", False, 5.0), ("tput", "maximize", False, 0.7)]
    js = J.MetricSet([J.MetricSpec(*s) for s in specs])
    ts = T.MetricSet([T.MetricSpec(*s) for s in specs])
    assert (ts.mode, ts.num_objectives, ts.num_constraints) == (
        js.mode, js.num_objectives, js.num_constraints)
    np.testing.assert_array_equal(ts.signed_thresholds(), js.signed_thresholds())
    rng = np.random.default_rng(0)
    for _ in range(20):
        vals = {"acc": rng.random(), "loss": rng.random(),
                "lat": 10 * rng.random(), "tput": rng.random()}
        np.testing.assert_array_equal(ts.signed_vector(vals), js.signed_vector(vals))
        assert ts.feasible(vals) == js.feasible(vals)
    assert not ts.feasible({"acc": 1.0, "loss": 1.0, "lat": float("nan"), "tput": 1.0})
    assert T.MetricSet.from_wire(js.to_wire()).to_wire() == js.to_wire()


@pytest.mark.parametrize("k", [2, 3])
def test_pareto_mask_and_hypervolume_twin(k):
    rng = np.random.default_rng(k)
    for _ in range(5):
        y = np.round(rng.random((25, k)), 1)  # ties and duplicates
        np.testing.assert_array_equal(T.pareto_mask(y), J.pareto_mask(y))
        ref = y.max(axis=0) + 0.5
        assert T.hypervolume(y, ref) == J.hypervolume(y, ref)


# ----------------------------------------------------------- acquisitions


def _moments(seed, S=3, M=3, m=17):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((S, M, m)), rng.random((S, m)) + 0.05, rng


@pytest.mark.parametrize("num_con", [0, 1, 2])
def test_closed_forms_twin(num_con):
    mu, var, rng = _moments(num_con)
    t_std = rng.standard_normal(num_con)
    np.testing.assert_allclose(
        TMA.feasibility_weight(t(mu[:, 1:1 + num_con]), t(var), t(t_std)).numpy(),
        np.asarray(JMA.feasibility_weight(jnp.asarray(mu[:, 1:1 + num_con]),
                                          jnp.asarray(var), jnp.asarray(t_std))),
        rtol=0, atol=1e-10)
    for feas in (True, False):
        np.testing.assert_allclose(
            TMA.constrained_ei(t(mu), t(var), -0.4, t(t_std), feas).numpy(),
            np.asarray(JMA.constrained_ei(jnp.asarray(mu), jnp.asarray(var),
                                          jnp.asarray(-0.4), jnp.asarray(t_std),
                                          jnp.asarray(feas))),
            rtol=0, atol=1e-10)
    w = rng.random((8, 3 - num_con)) + 1e-3
    w /= w.sum(axis=1, keepdims=True)
    ybw = rng.standard_normal(8)
    np.testing.assert_allclose(
        TMA.scalarized_ei(t(mu), t(var), t(w), t(ybw), t(t_std)).numpy(),
        np.asarray(JMA.scalarized_ei(jnp.asarray(mu), jnp.asarray(var), jnp.asarray(w),
                                     jnp.asarray(ybw), jnp.asarray(t_std))),
        rtol=0, atol=1e-10)


def _posteriors(n, S, d, M, seed):
    """The same shape-bucketed posterior and head block in both packages:
    factorized by the port, then handed to the JAX package as numpy (what
    is compared downstream is the head solve and the scoring)."""
    rng = np.random.default_rng(seed)
    nb = max(8, 1 << (n - 1).bit_length())
    x = np.zeros((nb, d))
    x[:n] = rng.random((n, d))
    mask = np.zeros(nb, dtype=bool)
    mask[:n] = True
    yh = np.zeros((M, nb))
    c = rng.standard_normal((M, d))
    yh[:, :n] = (np.sin(3.0 * x[:n] @ c.T + rng.random(M)).T
                 + 0.1 * rng.standard_normal((M, n)))
    yh[:, :n] -= yh[:, :n].mean(axis=1, keepdims=True)
    yh[:, :n] /= yh[:, :n].std(axis=1, keepdims=True)
    base = np.asarray(JP.default_params(d).pack())
    packed = np.stack([base + 0.1 * rng.standard_normal(3 * d + 2) for _ in range(S)])
    tpost = TG.fit_posterior_batch(
        t(x), t(yh[0]), TP.GPHyperParams.unpack(t(packed), d), t(mask, torch.bool),
        with_inverse=True,
    )
    jpost = JG.GPPosterior(
        x_train=jnp.asarray(x), mask=jnp.asarray(mask),
        chol=jnp.asarray(tpost.chol.numpy()), alpha=jnp.asarray(tpost.alpha.numpy()),
        params=JP.GPHyperParams.unpack(jnp.asarray(packed), d),
        chol_inv=jnp.asarray(tpost.chol_inv.numpy()),
    )
    return jpost, tpost, yh, rng


@pytest.mark.parametrize("n,S,d", [(6, 1, 2), (40, 4, 6)])
def test_solve_head_alphas_and_predict_heads_twin(n, S, d):
    jpost, tpost, yh, rng = _posteriors(n, S, d, 3, seed=n + S)
    ja = JM.solve_head_alphas(jpost, jnp.asarray(yh))
    ta = TM.solve_head_alphas(tpost, t(yh))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-10)
    np.testing.assert_allclose(ta[:, 0].numpy(), tpost.alpha.numpy(), rtol=0, atol=1e-10)
    xs = rng.random((50, d))
    jmu, jvar = JM.predict_heads(JM.MultiOutputPosterior(jpost, ja), jnp.asarray(xs))
    tmu, tvar = TM.predict_heads(TM.MultiOutputPosterior(tpost, ta), t(xs))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tvar.numpy(), np.asarray(jvar), rtol=0, atol=1e-10)


# --------------------------------------------------------- acq_score_multi


def assert_scores_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-10 * max(1.0, float(np.abs(want).max())))


HEADS = 4  # one head block for every mode, so each shape compiles once


def _heads(mode, rng):
    """One mode's head inputs (numpy) over four heads, in the layouts the
    engine builds: constrained = objective + 3 constraints; pareto = 2
    objectives + 2 constraints, 16 draws; rungs = objective + 3 rungs; cost =
    objective + log-cost head (heads 2-3 unused)."""
    if mode == "constrained":
        return dict(t_std=np.array([0.4, -0.3, 0.9]), y_best=-0.6, has_feasible=True,
                    weights=np.zeros((0, 1)), y_best_w=np.zeros((0,)))
    if mode == "pareto":
        w = rng.random((16, 2)) + 1e-3
        return dict(t_std=np.array([0.3, 0.8]), y_best=0.0, has_feasible=True,
                    weights=w / w.sum(axis=1, keepdims=True),
                    y_best_w=rng.standard_normal(16))
    if mode == "rungs":
        return dict(t_std=np.zeros((0,)), y_best=0.0, has_feasible=True,
                    weights=rung_head_weights([1, 3, 9], HEADS - 1),
                    y_best_w=rng.standard_normal(HEADS))
    return dict(t_std=np.zeros((0,)), y_best=-0.5, has_feasible=True,
                weights=np.array([[1.7]]), y_best_w=np.zeros((1,)))


def _multi_case(mode, n, S, d, seed):
    jpost, tpost, yh, rng = _posteriors(n, S, d, HEADS, seed)
    ja = JM.solve_head_alphas(jpost, jnp.asarray(yh))
    h = _heads(mode, rng)
    jhead = JHead(alphas=ja, **{k: jnp.asarray(v) for k, v in h.items()})
    thead = THead(alphas=t(np.asarray(ja)), t_std=t(h["t_std"]), y_best=h["y_best"],
                  has_feasible=h["has_feasible"], weights=t(h["weights"]),
                  y_best_w=t(h["y_best_w"]))
    xs = rng.random((70, d))
    return jpost, tpost, jhead, thead, h, xs


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [6, 40])
@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("d", [2, 6])
def test_acq_score_multi_plain_matches_oracle(mode, n, S, d):
    jpost, tpost, jhead, thead, h, xs = _multi_case(mode, n, S, d, seed=7 * n + S + d)
    got = acq_score_multi(tpost, thead, t(xs), mode=mode).numpy()
    assert got.shape == (S, 70)
    want = np.asarray(multi_ref(
        jpost, jhead.alphas, jnp.asarray(xs), mode=mode, t_std=jhead.t_std,
        y_best=jhead.y_best, has_feasible=h["has_feasible"],
        weights=jhead.weights, y_best_w=jhead.y_best_w,
    ))
    assert_scores_close(got, want)
    # the torch composition agrees with the fused path's plain version
    assert_scores_close(
        acq_score_multi(tpost, thead, t(xs), mode=mode, backend="torch").numpy(), got)


@pytest.mark.pallas
@pytest.mark.parametrize("mode", MODES)
def test_acq_score_multi_plain_matches_pallas(mode):
    jpost, tpost, jhead, thead, _, xs = _multi_case(mode, 20, 3, 3, seed=11)
    got = acq_score_multi(tpost, thead, t(xs), mode=mode).numpy()
    want = np.asarray(j_acq_score_multi(jpost, jhead, jnp.asarray(xs), mode=mode,
                                        backend="pallas"))
    assert_scores_close(got, want)


def test_constrained_without_feasible_incumbent_is_pure_feasibility():
    _, tpost, _, thead, _, xs = _multi_case("constrained", 12, 2, 3, seed=4)
    infeasible = thead._replace(has_feasible=False)
    got = acq_score_multi(tpost, infeasible, t(xs), mode="constrained")
    mu, var = TM.predict_heads(TM.MultiOutputPosterior(tpost, thead.alphas), t(xs))
    feas = TMA.feasibility_weight(mu[:, 1:], var, thead.t_std)
    assert float(feas.max()) > 0.0
    np.testing.assert_allclose(got.numpy(), feas.numpy(), rtol=0, atol=1e-12)


def test_multi_cpu_runs_plain_and_counts_no_launch():
    K.reset_launch_counts()
    _, tpost, _, thead, _, xs = _multi_case("pareto", 10, 2, 2, seed=3)
    acq_score_multi(tpost, thead, t(xs), mode="pareto")
    assert K.LAUNCHES == {name: 0 for name in K.KERNEL_NAMES}
    assert "acq_score_multi" in K.KERNEL_NAMES


def test_multi_cuda_path_raises_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the launch path runs instead")
    _, tpost, _, thead, _, xs = _multi_case("cost", 10, 2, 2, seed=3)
    args = pack_multi_inputs(tpost, thead, t(xs), "cost")
    monkeypatch.setattr(acq_kernel_mod, "check_inputs", lambda *a: "cuda")
    with pytest.raises(RuntimeError, match="needs an NVIDIA card"):
        acq_score_multi_kernel(*args)


def test_multi_wrapper_rejects_bad_inputs():
    _, tpost, _, thead, _, xs = _multi_case("pareto", 10, 2, 2, seed=5)
    args = list(pack_multi_inputs(tpost, thead, t(xs), "pareto"))
    with pytest.raises(ValueError, match="unsupported mode"):
        acq_score_multi_kernel(*args[:-2], "ucb", args[-1])
    bad = list(args)
    bad[12] = bad[12][:-1].contiguous()  # one incumbent short of the draws
    with pytest.raises(ValueError, match="do not fit"):
        acq_score_multi_kernel(*bad)
    bad = list(args)
    bad[3] = bad[3][:, :, :-1].contiguous()  # alphas one row short
    with pytest.raises(ValueError, match="shape"):
        acq_score_multi_kernel(*bad)
    with pytest.raises(ValueError, match="do not fit"):  # rungs needs (1, M)
        acq_score_multi_kernel(*args[:-2], "rungs", 0)


def test_multi_wrapper_takes_at_most_one_tile_of_heads(monkeypatch):
    """The heads ride under L⁻¹ as one 16-row tile of the product: more
    than 16 are refused before any launch."""
    _, tpost, _, thead, _, xs = _multi_case("constrained", 10, 2, 2, seed=6)
    args = list(pack_multi_inputs(tpost, thead, t(xs), "constrained"))
    S, _, n = args[3].shape
    args[3] = torch.zeros((S, 17, n), dtype=torch.float64)
    monkeypatch.setattr(acq_kernel_mod, "check_inputs", lambda *a: "cuda")
    with pytest.raises(ValueError, match="at most 16 heads"):
        acq_score_multi_kernel(*args)


def _spread_epilogue(mode, mu, var, t_std, y_best, has_feasible, weights, y_best_w):
    """The multi kernel's epilogue as its four lanes per anchor compute it:
    lane j takes constraint factors, draws (pareto) or heads (rungs) j,
    j + 4, …; the lanes' partials meet by two butterfly steps."""
    from scipy.special import erf

    def ei(m, s, inc):
        g = (inc - m) / s
        cdf = 0.5 * (1 + erf(g / math.sqrt(2)))
        e = s * (g * cdf + np.exp(-0.5 * g * g) / math.sqrt(2 * math.pi))
        return np.maximum(e, 0.0)

    def meet(parts, op):
        a, b = op(parts[0], parts[1]), op(parts[2], parts[3])
        return op(a, b)

    M, C = mu.shape[1], len(t_std)
    sigma = np.sqrt(np.maximum(var, 1e-12))
    feas_parts = [np.ones_like(sigma) for _ in range(4)]
    for c in range(C):
        z = (t_std[c] - mu[:, M - C + c]) / sigma
        feas_parts[c % 4] = feas_parts[c % 4] * 0.5 * (1 + erf(z / math.sqrt(2)))
    feas = meet(feas_parts, np.multiply)
    if mode == "constrained":
        e0 = ei(mu[:, 0], sigma, y_best)
        return e0 * feas if has_feasible else feas
    if mode == "pareto":
        parts = [np.zeros_like(sigma) for _ in range(4)]
        for v, w in enumerate(weights):
            ms = np.einsum("k,skm->sm", w, mu[:, : len(w)])
            parts[v % 4] = parts[v % 4] + ei(ms, sigma * np.sqrt(np.sum(w * w)), y_best_w[v])
        return meet(parts, np.add) / len(weights) * feas
    if mode == "rungs":
        parts = [np.zeros_like(sigma) for _ in range(4)]
        for h in range(M):
            parts[h % 4] = parts[h % 4] + weights[0, h] * ei(mu[:, h], sigma, y_best_w[h])
        return meet(parts, np.add)
    return ei(mu[:, 0], sigma, y_best) * np.exp(-weights[0, 0] * mu[:, 1])


@pytest.mark.parametrize("mode", MODES)
def test_spread_epilogue_matches_the_closed_forms(mode):
    from repro_torch.kernels.acq_score.plain import multi_closed_form

    rng = np.random.default_rng(11)
    S, m = 3, 50
    mu = rng.standard_normal((S, HEADS, m))
    var = rng.random((S, m)) * 2.0
    h = _heads(mode, rng)
    got = _spread_epilogue(mode, mu, var, h["t_std"], h["y_best"], h["has_feasible"],
                           h["weights"], h["y_best_w"])
    want = multi_closed_form(t(mu), t(var), mode, t(h["t_std"]), h["y_best"],
                             h["has_feasible"], t(h["weights"]), t(h["y_best_w"])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


# ------------------------------------------------------------ tuner twins


PKG = {
    "jax": dict(C=J, SC=JSC, Acq=JAcq, Sim=JSim, backend="pallas", kw={}),
    "torch": dict(C=T, SC=TSC, Acq=TAcq, Sim=TSim, backend="kernel",
                  kw={"device": "cpu"}),
}


def space_of(C):
    return C.SearchSpace([
        C.Continuous("lr", 1e-4, 1.0, scaling="log"),
        C.Continuous("x", 0.0, 1.0),
        C.Integer("k", 1, 6),
    ])


def metrics_of(cfg):
    u = math.log10(cfg["lr"]) + 2.0
    loss = u * u + (cfg["x"] - 0.3) ** 2 + 0.1 * (cfg["k"] - 3) ** 2
    size = (cfg["x"] - 0.8) ** 2 + 0.05 * cfg["k"] + 0.1 * abs(u)
    lat = 0.3 * cfg["k"] + cfg["x"]
    return {"loss": loss, "size": size, "lat": lat}


def objective(cfg):
    m = metrics_of(cfg)
    return [m["loss"] + 0.5, m["loss"]], 1.0 + 0.1 * cfg["k"], m


def specs(C, pareto):
    out = [C.MetricSpec("loss")]
    if pareto:
        out.append(C.MetricSpec("size"))
    out.append(C.MetricSpec("lat", objective=False, threshold=1.2))
    return tuple(out)


def bo_config(pkg, **over):
    p = PKG[pkg]
    acq = p["Acq"](**over.pop("acq", SMALL_ACQ))
    return p["C"].BOConfig(slice_config=p["SC"](**TINY), acq=acq,
                           backend=p["backend"], **over)


def run_tuner(pkg, pareto, trials=10, parallel=2, **over):
    p = PKG[pkg]
    space = space_of(p["C"])
    sugg = p["C"].BOSuggester(space, bo_config(pkg, **over), seed=0, **p["kw"])
    tuner = p["C"].Tuner(space, objective, sugg, p["Sim"](), p["C"].TuningJobConfig(
        max_trials=trials, max_parallel=parallel, metrics=specs(p["C"], pareto)))
    return space, tuner.run()


def assert_same_tables(res_t, res_j, space):
    assert len(res_t.trials) == len(res_j.trials)
    assert all(t.state == "COMPLETED" for t in res_t.trials)
    enc_t = np.stack([space.encode(t.config) for t in res_t.trials])
    enc_j = np.stack([space.encode(t.config) for t in res_j.trials])
    np.testing.assert_allclose(enc_t, enc_j, rtol=0, atol=1e-9)
    assert [t.config["k"] for t in res_t.trials] == [t.config["k"] for t in res_j.trials]
    assert res_t.best_trial.trial_id == res_j.best_trial.trial_id
    assert [t.trial_id for t in res_t.pareto_front] == [t.trial_id for t in res_j.pareto_front]


@pytest.mark.parametrize("pareto", [False, True], ids=["constrained", "pareto"])
def test_tuner_twin(pareto):
    space, res_j = run_tuner("jax", pareto)
    _, res_t = run_tuner("torch", pareto)
    assert_same_tables(res_t, res_j, space)
    ms = T.MetricSet(specs(T, pareto))
    assert ms.feasible(res_t.best_trial.metrics)
    assert res_t.pareto_front


def test_tuner_twin_liar_pending():
    """In-flight trials folded in as constant-liar fantasies on every head."""
    space, res_j = run_tuner("jax", True, trials=9, parallel=3, pending_strategy="liar")
    _, res_t = run_tuner("torch", True, trials=9, parallel=3, pending_strategy="liar")
    assert_same_tables(res_t, res_j, space)


def _store(C, space, rows, pareto):
    store = C.ObservationStore(space, metrics=C.MetricSet(specs(C, pareto)))
    for i, c in enumerate(rows):
        store.push_metrics(c, metrics_of(c), key=i)
    return store


def test_jax_pareto_state_dict_loads_into_port():
    js, ts = space_of(J), space_of(T)
    rows = list(js.sample(np.random.default_rng(5), 6))
    jstore = _store(J, js, rows, True)
    over = dict(refit_every=2, pending_strategy="kb")
    jsugg = J.BOSuggester(js, bo_config("jax", **over), seed=3, store=jstore)
    for c in jsugg.suggest_batch(2):  # mid-job: draws cached, RNG advanced
        rows.append(c)
        jstore.push_metrics(c, metrics_of(c), key=len(rows))
    state = json.loads(json.dumps(jsugg.state_dict()))  # as a checkpoint holds it
    tstore = _store(T, ts, rows, True)
    tsugg = T.BOSuggester(ts, bo_config("torch", **over), seed=3, store=tstore,
                          device="cpu")
    tsugg.load_state_dict(state)
    for _ in range(2):
        got, want = tsugg.suggest_batch(1), jsugg.suggest_batch(1)
        np.testing.assert_allclose(ts.encode_batch(got), js.encode_batch(want),
                                   rtol=0, atol=1e-9)
        for c in want:
            jstore.push_metrics(c, metrics_of(c))
            tstore.push_metrics(c, metrics_of(c))
    assert tsugg.state_dict()["rng_state"] == jsugg.state_dict()["rng_state"]


def test_refusals_twin():
    """acq="lcb" is refused for M > 1 in both packages; per-head GPHP chains
    are not ported and say where they wait."""
    for pkg in ("jax", "torch"):
        C = PKG[pkg]["C"]
        space = space_of(C)
        store = _store(C, space, space.sample(np.random.default_rng(0), 4), False)
        cfg = bo_config(pkg, acq=dict(SMALL_ACQ, acq="lcb"))
        with pytest.raises(ValueError, match="acq='ei'"):
            C.BOSuggester(space, cfg, seed=0, store=store, **PKG[pkg]["kw"])
    with pytest.raises(NotImplementedError, match="item 10"):
        T.BOConfig(per_head_gphp=True)
