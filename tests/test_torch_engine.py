"""The port's decision loop as a whole against the JAX package's.

* A ``Tuner`` on ``SimBackend`` runs the same job in both packages — JAX
  with ``BOConfig(backend="pallas")`` (interpret mode), the port with its
  defaults (fused ``"kernel"`` scoring, whose CPU path is the plain
  version) on ``device="cpu"``. The trial tables agree to 1e-9 in encoded
  space and integer values are equal: same threefry key stream, same slice
  chains, same anchors, same argmax.
* A JAX ``BOSuggester.state_dict()`` taken mid-job loads into the port
  unchanged, and the next decisions match.
"""

import json
import math

import numpy as np
import pytest
import torch

import repro.core as J
from repro.core.gp.slice_sampler import SliceSamplerConfig as JSC
from repro.core.optimize_acq import AcqOptConfig as JAcq
from repro.core.scheduler import SimBackend as JSim
import repro_torch.core as T
from repro_torch.core.gp.slice_sampler import SliceSamplerConfig as TSC
from repro_torch.core.optimize_acq import AcqOptConfig as TAcq
from repro_torch.core.scheduler import SimBackend as TSim

torch.backends.cuda.matmul.allow_tf32 = False

TINY = dict(num_samples=12, burn_in=6, thin=2)
SMALL_ACQ = dict(num_anchors=128, num_refine=4, refine_steps=5)

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


def objective(cfg):
    f = ((math.log10(cfg["lr"]) + 2.0) ** 2 + (cfg["x"] - 0.3) ** 2
         + 0.1 * (cfg["k"] - 3) ** 2)
    return [f + 1.0, f + 0.5, f], 1.0 + 0.1 * cfg["k"]


def bo_config(pkg, **over):
    p = PKG[pkg]
    acq = p["Acq"](**over.pop("acq", SMALL_ACQ))
    return p["C"].BOConfig(slice_config=p["SC"](**TINY), acq=acq,
                           backend=p["backend"], **over)


def run_tuner(pkg, trials=12, parallel=2, **over):
    p = PKG[pkg]
    space = space_of(p["C"])
    sugg = p["C"].BOSuggester(space, bo_config(pkg, **over), seed=0, **p["kw"])
    tuner = p["C"].Tuner(space, objective, sugg, p["Sim"](),
                         p["C"].TuningJobConfig(max_trials=trials, max_parallel=parallel))
    res = tuner.run()
    return space, res


def assert_same_tables(res_t, res_j, space):
    assert len(res_t.trials) == len(res_j.trials)
    enc_t = np.stack([space.encode(t.config) for t in res_t.trials])
    enc_j = np.stack([space.encode(t.config) for t in res_j.trials])
    np.testing.assert_allclose(enc_t, enc_j, rtol=0, atol=1e-9)
    assert [t.config["k"] for t in res_t.trials] == [t.config["k"] for t in res_j.trials]
    assert res_t.best_objective == pytest.approx(res_j.best_objective, abs=1e-9)


@pytest.mark.parametrize("refit_every", [1, 3])
def test_tuner_twin(refit_every):
    space, res_j = run_tuner("jax", refit_every=refit_every)
    _, res_t = run_tuner("torch", refit_every=refit_every)
    assert all(t.state == "COMPLETED" for t in res_t.trials)
    assert_same_tables(res_t, res_j, space)


@pytest.mark.parametrize("strategy", ["liar", "kb"])
def test_tuner_twin_fantasy_pending(strategy):
    """Pending trials folded in as fantasies (rank-1 appends + alpha
    refresh on a scratch posterior)."""
    space, res_j = run_tuner("jax", trials=10, parallel=3, pending_strategy=strategy)
    _, res_t = run_tuner("torch", trials=10, parallel=3, pending_strategy=strategy)
    assert_same_tables(res_t, res_j, space)


def test_tuner_twin_default_acquisition_pipeline():
    """The paper's anchor pipeline (1024 anchors, 8 refined for 25 Adam
    steps), fused scoring on both sides."""
    over = dict(acq=dict(), refit_every=2)
    space, res_j = run_tuner("jax", trials=8, **over)
    _, res_t = run_tuner("torch", trials=8, **over)
    assert_same_tables(res_t, res_j, space)


def _store(C, space, rows):
    store = C.ObservationStore(space)
    for i, (c, y) in enumerate(rows):
        store.push(c, y, key=i)
    return store


def test_jax_state_dict_loads_into_port():
    js, ts = space_of(J), space_of(T)
    rng = np.random.default_rng(5)
    rows = [(c, objective(c)[0][-1]) for c in js.sample(rng, 6)]
    jstore = _store(J, js, rows)
    jsugg = J.BOSuggester(js, bo_config("jax", refit_every=2), seed=3, store=jstore)
    for _ in range(2):  # mid-job: draws cached, cadence part-way to a refit
        for i, c in enumerate(jsugg.suggest_batch(2)):
            rows.append((c, objective(c)[0][-1]))
            jstore.push(c, rows[-1][1], key=len(rows))
    state = json.loads(json.dumps(jsugg.state_dict()))  # as a checkpoint holds it
    assert state["cached_samples"] is not None

    tstore = _store(T, ts, rows)
    tsugg = T.BOSuggester(ts, bo_config("torch", refit_every=2), seed=3,
                          store=tstore, device="cpu")
    tsugg.load_state_dict(state)
    for step in range(3):
        got, want = tsugg.suggest_batch(2), jsugg.suggest_batch(2)
        np.testing.assert_allclose(ts.encode_batch(got), js.encode_batch(want),
                                   rtol=0, atol=1e-9)
        for c in want:
            y = objective(c)[0][-1]
            jstore.push(c, y)
            tstore.push(c, y)
    # and the port's own state_dict has the same schema and values
    tstate, jstate = tsugg.state_dict(), jsugg.state_dict()
    assert set(tstate) == set(jstate)
    assert tstate["key"] == jstate["key"]
    np.testing.assert_allclose(tstate["cached_samples"], jstate["cached_samples"],
                               rtol=0, atol=1e-9)


def test_port_state_dict_restore_continues_stream():
    ts = space_of(T)
    rng = np.random.default_rng(2)
    rows = [(c, objective(c)[0][-1]) for c in ts.sample(rng, 5)]
    cfg = bo_config("torch", refit_every=3)
    live = T.BOSuggester(ts, cfg, seed=1, store=_store(T, ts, rows), device="cpu")
    live.suggest_batch(1)
    state = json.loads(json.dumps(live.state_dict()))
    restored = T.BOSuggester(ts, cfg, seed=1, store=_store(T, ts, rows), device="cpu")
    restored.load_state_dict(state)
    assert restored.suggest_batch(2) == live.suggest_batch(2)


def test_suggest_history_wrapper_twin_with_pending():
    """The stateless ``suggest(history, pending)`` API, kriging believer."""
    js, ts = space_of(J), space_of(T)
    rng = np.random.default_rng(8)
    hist = [(c, objective(c)[0][-1]) for c in js.sample(rng, 7)]
    pending = js.sample(rng, 2)
    jsugg = J.BOSuggester(js, bo_config("jax", pending_strategy="kb"), seed=0)
    tsugg = T.BOSuggester(ts, bo_config("torch", pending_strategy="kb"), seed=0,
                          device="cpu")
    got, want = tsugg.suggest(hist, pending), jsugg.suggest(hist, pending)
    np.testing.assert_allclose(ts.encode(got), js.encode(want), rtol=0, atol=1e-9)


def test_random_and_sobol_suggesters_twin():
    js, ts = space_of(J), space_of(T)
    assert T.RandomSuggester(ts, 4).suggest_batch(5) == J.RandomSuggester(js, 4).suggest_batch(5)
    assert T.SobolSuggester(ts, 4).suggest_batch(5) == J.SobolSuggester(js, 4).suggest_batch(5)


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.BOSuggester(space_of(T), bo_config("torch"))


def test_unported_options_refuse_clearly():
    # the subset backend and per-head chains construct; their knobs are
    # validated as the JAX package validates them, with the same error type
    assert T.BOConfig(posterior_backend="subset").max_inducing == 1024
    assert T.BOConfig(per_head_gphp=True).per_head_gphp
    for C in (J, T):
        with pytest.raises(ValueError, match="posterior_backend"):
            C.BOConfig(posterior_backend="vortex")
        with pytest.raises(ValueError, match="max_inducing"):
            C.BOConfig(posterior_backend="subset", max_inducing=1)
    # MAP-II differentiates the gram: the kernel gram has no backward, so the
    # config refuses before any work instead of falling back to the torch gram
    with pytest.raises(ValueError, match="no backward"):
        T.BOConfig(gphp_method="map", fit_backend="kernel")
    with pytest.raises(ValueError, match="no backward"):
        bo_config("torch", gphp_method="map", fit_backend="kernel")
    sugg = T.BOSuggester(space_of(T), bo_config("torch", gphp_method="map"),
                         device="cpu")
    ts = space_of(T)
    store = _store(T, ts, [(c, 1.0 + i) for i, c in
                           enumerate(ts.sample(np.random.default_rng(0), 4))])
    sugg.bind_store(store)
    assert len(sugg.suggest_batch(1)) == 1  # the torch gram's MAP fit runs
