"""The port's telemetry on the decision path, on the CPU.

* A GP decision (``suggest_batch(2)`` with trials in flight, folded in by
  the constant liar) records the stages of the acquisition optimizer
  (``acq.anchors``, ``acq.refine``, ``acq.rerank``) under each
  ``suggest.acq_opt``, the refit's host draw table, upload and chain
  (``gphp.draws``, ``gphp.upload``, ``gphp.chain``) under
  ``suggest.gphp_fit``, and ``suggest.pending_fold`` under
  ``suggest.decide``; every span the decision recorded before keeps its name
  and parent. Both decision paths: single-metric and constrained (M = 2,
  shared factor).
* Telemetry on and off give the same picks and GPHP samples bit for bit.
* With telemetry off nothing is recorded and every site returns the shared
  no-op span.
* ``device_span`` waits for a CUDA device before it closes, and only while
  recording.
* The span contract: every GP decision path (single-metric liar,
  constrained, per-head GPHP chains, cost-aware, rung heads), at each stage
  of the factor lifecycle (a refit, rank-1 appends, a replay after the
  factors were dropped), records a fixed multiset of (span, parent) pairs
  and ``suggest.*`` counters — what the benchmark's metrics and
  ``chip_smoke.py`` read.
"""

import collections

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import telemetry
from repro_torch.core.asha import ASHAConfig
from repro_torch.core.gp.slice_sampler import SliceSamplerConfig
from repro_torch.core.multifidelity import MultiFidelityState
from repro_torch.core.optimize_acq import AcqOptConfig

PATHS = ["single", "constrained"]
NEW_SPANS = {"acq.anchors", "acq.refine", "acq.rerank", "gphp.draws", "gphp.upload",
             "gphp.chain", "suggest.pending_fold"}
K = 2  # configurations a call picks
REFINE = AcqOptConfig(num_anchors=64, num_refine=4, refine_steps=3)

#: (span, parent span) of every span a GP decision records; None is the root
EDGES = {
    "suggest.encode": None,
    "suggest.decide": None,
    "suggest.posterior": "suggest.decide",
    "suggest.gphp_fit": "suggest.posterior",
    "suggest.factorize": "suggest.posterior",
    "suggest.pending_fold": "suggest.decide",
    "suggest.acq_opt": "suggest.decide",
    "suggest.dedup": "suggest.decide",
    "acq.anchors": "suggest.acq_opt",
    "acq.refine": "suggest.acq_opt",
    "acq.rerank": "suggest.acq_opt",
    "gphp.draws": "suggest.gphp_fit",
    "gphp.upload": "suggest.gphp_fit",
    "gphp.chain": "suggest.gphp_fit",
}
MULTI_EDGES = {"suggest.head_alphas": "suggest.decide"}


def _space():
    return T.SearchSpace([
        T.Continuous("lr", 1e-4, 1.0, scaling="log"),
        T.Continuous("x", 0.0, 1.0),
        T.Integer("k", 1, 6),
    ])


def _metrics(c):
    u = np.log10(c["lr"]) + 2.0
    return {"loss": u * u + (c["x"] - 0.3) ** 2 + 0.1 * (c["k"] - 3) ** 2,
            "lat": 0.3 * c["k"] + c["x"]}


def _push(store, path, c, key):
    m = _metrics(c)
    if path in ("constrained", "per_head"):
        store.push_metrics(c, m, key=key)
    else:
        store.push(c, m["loss"], key=key, cost=1.0 + m["lat"] if path == "cost" else None)


def _suggester(path, **over):
    """A fresh engine over 6 seeded observations with 2 trials in flight.
    ``path`` "single", "cost" and "rungs" keep one metric; "constrained" and
    "per_head" add a latency constraint."""
    space = _space()
    if path in ("constrained", "per_head"):
        store = T.ObservationStore(space, metrics=T.MetricSet(
            (T.MetricSpec("loss"), T.MetricSpec("lat", objective=False, threshold=1.2))))
    else:
        store = T.ObservationStore(space)
    rng = np.random.default_rng(5)
    for i in range(6):
        _push(store, path, space.decode(rng.random(space.encoded_dim)), i)
    for i in range(6, 8):
        store.mark_pending(i, space.decode(rng.random(space.encoded_dim)))
    cfg = T.BOConfig(slice_config=SliceSamplerConfig(num_samples=12, burn_in=6, thin=2),
                     acq=REFINE, pending_strategy="liar", cost_aware=path == "cost",
                     per_head_gphp=path == "per_head", **over)
    sugg = T.BOSuggester(space, cfg, seed=11, store=store, device="cpu")
    if path == "rungs":
        mf = sugg.multi_fidelity_state = MultiFidelityState(ASHAConfig())
        for i in range(6):
            mf.report_rung(i, 1, float(store.standardized()[1][i]) + 0.5)
    return sugg


@pytest.fixture
def registry(monkeypatch):
    """The global registry, emptied, with every span a site opens recorded
    as (name, what the site got back); recording is off afterwards."""
    tel = telemetry.get()
    was = tel.enabled
    tel.reset()
    opened = []
    span, device_span = telemetry.span, telemetry.device_span

    def spy(open_):
        def wrapped(name, *args, **attrs):
            cm = open_(name, *args, **attrs)
            opened.append((name, cm))
            return cm
        return wrapped

    monkeypatch.setattr(telemetry, "span", spy(span))
    monkeypatch.setattr(telemetry, "device_span", spy(device_span))
    yield tel, opened
    tel.set_enabled(was)
    tel.reset()


def _decide(path, on):
    """(picks, GPHP samples, spans and events) of one GP decision."""
    telemetry.set_enabled(on)
    sugg = _suggester(path)
    picks = sugg.suggest_batch(K)
    events = telemetry.get().trace_events()
    telemetry.set_enabled(False)
    return picks, np.array(sugg.cache.samples), events


@pytest.mark.parametrize("path", PATHS)
def test_spans_nest_under_their_parents(path, registry):
    _, _, events = _decide(path, True)
    spans = [e for e in events if e["kind"] == "span"]
    by_id = {e["span_id"]: e for e in events}
    edges = {}
    for s in spans:
        parent = by_id[s["parent_id"]]["name"] if s["parent_id"] is not None else None
        assert edges.setdefault(s["name"], parent) == parent, s["name"]
    assert edges == {**EDGES, **(MULTI_EDGES if path == "constrained" else {})}
    names = [s["name"] for s in spans]
    assert names.count("suggest.acq_opt") == K
    for stage in ("acq.anchors", "acq.refine", "acq.rerank"):
        # one of each under each slot's span, in order
        parents = [by_id[s["parent_id"]] for s in spans if s["name"] == stage]
        assert [p["attrs"]["slot"] for p in parents] == list(range(K))
    for s in spans:
        if s["name"] == "acq.refine":
            assert s["attrs"] == {"steps": REFINE.refine_steps, "points": REFINE.num_refine}
        if s["name"] == "suggest.pending_fold":
            assert s["attrs"] == {"pending": 2}
    for stage in ("gphp.draws", "gphp.upload", "gphp.chain"):
        assert names.count(stage) == 1
    fit = next(s for s in spans if s["name"] == "suggest.gphp_fit")
    stages = sorted((s for s in spans if s["parent_id"] == fit["span_id"]),
                    key=lambda s: s["t0"])
    assert [s["name"] for s in stages] == ["gphp.draws", "gphp.upload", "gphp.chain"]
    assert all(fit["t0"] <= s["t0"] <= s["t1"] <= fit["t1"] for s in stages)
    # the chain's event stays, under the refit
    chain = [e for e in events if e["name"] == "gphp.slice_chain"]
    assert len(chain) == 1 and chain[0]["kind"] == "event"
    assert by_id[chain[0]["parent_id"]]["name"] == "suggest.gphp_fit"


@pytest.mark.parametrize("path", PATHS)
def test_on_and_off_decide_bit_for_bit(path, registry):
    picks_off, samples_off, _ = _decide(path, False)
    picks_on, samples_on, events = _decide(path, True)
    assert events
    assert picks_on == picks_off
    assert samples_on.tobytes() == samples_off.tobytes()


@pytest.mark.parametrize("path", PATHS)
def test_off_records_nothing_and_sites_return_the_null_span(path, registry):
    tel, opened = registry
    _decide(path, False)
    assert tel.trace_events() == []
    assert tel.metrics()["counters"] == {} and tel.metrics()["histograms"] == {}
    seen = {name for name, _ in opened}
    assert NEW_SPANS <= seen
    assert all(cm is telemetry._NULL_SPAN for _, cm in opened)


def test_device_span_waits_for_a_card_only_while_recording(monkeypatch):
    ticks = iter(range(100))
    log = []
    tel = telemetry.Telemetry(clock=lambda: log.append("clock") or next(ticks))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: log.append(("sync", dev)))
    cuda = torch.device("cuda")
    assert tel.device_span("acq.refine", cuda) is telemetry._NULL_SPAN
    with tel.device_span("acq.refine", cuda):
        pass
    assert log == [] and tel.trace_events() == []
    tel.set_enabled(True)
    with tel.device_span("acq.refine", cuda, steps=3):
        log.append("body")
    # the wait lies inside the span: after the body, before the closing clock
    assert log == ["clock", "body", ("sync", cuda), "clock"]
    (span,) = tel.trace_events()
    assert span["name"] == "acq.refine" and span["attrs"] == {"steps": 3}
    log.clear()
    with tel.device_span("gphp.upload", torch.device("cpu")):
        pass
    assert ("sync", cuda) not in log and len(tel.trace_events()) == 2


CONTRACT_PATHS = ["single", "constrained", "per_head", "cost", "rungs"]
#: the factor spans of each lifecycle stage, (objective, per-head)
STAGE_SPANS = {
    "refit": (("suggest.gphp_fit", "suggest.factorize"),
              ("suggest.head_gphp_fit", "suggest.head_factorize")),
    "append": (("suggest.rank1_append",), ("suggest.head_append",)),
    "rebuild": (("suggest.factor_rebuild",), ("suggest.head_rebuild",)),
}


def _contract(path, stage):
    """The (span, parent) multiset and ``suggest.*`` counters of one
    decision: suggest_batch(K) with 2 trials in flight, folded in by the
    constant liar."""
    top = "suggest.rungs" if path == "rungs" else "suggest.decide"
    want = collections.Counter({
        ("suggest.encode", None): 1,
        ("suggest.decide", None): 1,
        ("suggest.posterior", "suggest.decide"): 1,
        ("suggest.pending_fold", top): 1,
        ("suggest.acq_opt", top): K,
        ("suggest.dedup", top): K,
        **{(stage_, "suggest.acq_opt"): K
           for stage_ in ("acq.anchors", "acq.refine", "acq.rerank")},
    })
    obj, head = STAGE_SPANS[stage]
    for name in obj:
        want[(name, "suggest.posterior")] += 1
    if path == "per_head":  # one extra head, outside the posterior span
        for name in head:
            want[(name, "suggest.decide")] += 1
    elif path != "single":  # the shared factor's head alphas: before and
        # after the pending fold, and after each slot's fantasy but the last
        want[("suggest.head_alphas", top)] += 1 + 1 + (K - 1)
    if path == "rungs":
        want[("suggest.rungs", "suggest.decide")] += 1
    fits = [n for n in ("suggest.gphp_fit", "suggest.head_gphp_fit")
            if any(n == name for name, _ in want)]
    for fit in fits:
        for stage_ in ("gphp.draws", "gphp.upload", "gphp.chain"):
            want[(stage_, fit)] += 1
    counters = {"suggest.gphp.refit": 1} if stage == "refit" else {}
    return want, counters


@pytest.mark.parametrize("stage", list(STAGE_SPANS))
@pytest.mark.parametrize("path", CONTRACT_PATHS)
def test_decision_span_contract(path, stage, registry):
    """One decision records exactly the spans (each under its parent, each
    as many times) and ``suggest.*`` counters its path and its factor stage
    call for. "append" and "rebuild" follow a first decision and one new
    observation under ``refit_every=10``; "rebuild" drops the factors in
    between, as an arena eviction does."""
    sugg = _suggester(path, refit_every=10)
    if stage != "refit":
        sugg.suggest_batch(K)
        rng = np.random.default_rng(9)
        _push(sugg._store, path, sugg.space.decode(rng.random(sugg.space.encoded_dim)), 8)
        if stage == "rebuild":
            sugg.cache.drop_factors()
    telemetry.set_enabled(True)
    sugg.suggest_batch(K)
    events = telemetry.get().trace_events()
    counters = telemetry.get().metrics()["counters"]
    telemetry.set_enabled(False)
    by_id = {e["span_id"]: e for e in events if e["kind"] == "span"}
    got = collections.Counter(
        (e["name"], None if e["parent_id"] is None else by_id[e["parent_id"]]["name"])
        for e in by_id.values()
    )
    want, want_counters = _contract(path, stage)
    assert got == want
    assert {k: v for k, v in counters.items() if k.startswith("suggest.")} == want_counters
