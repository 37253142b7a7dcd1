"""The acquisition refinement's CUDA graph (``core/optimize_acq.py``).

On the CPU: ``y_best`` as a 0-d float64 tensor (the graph's buffer) scores
and differentiates bit for bit as the Python float does, the CPU runs the
eager body and counts it, and the cache key tells apart every shape and
setting a capture bakes in.

On the card (``-m card``; skipped without one): a graph captured on one
posterior and replayed on another of the same shapes gives the eager loop's
points on the second bit for bit, for EI and LCB, also from two threads;
a shape captures once and replays after, and again once evicted. This file
imports no JAX, so the card tests run where JAX is not installed, without
the suite's conftest (``-s`` shows each bucket's capture time and bytes):
``python -m pytest -q --noconftest -m card tests/test_torch_acq_graph.py``.
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import acquisition as A
from repro_torch.core import optimize_acq as O
from repro_torch.core import prng, telemetry
from repro_torch.core.gp.gp import fit_posterior_batch
from repro_torch.core.gp.params import GPHyperParams


def posterior(seed, n_live, bucket, S, d, device="cpu"):
    """A factorized S-sample posterior over ``n_live`` seeded rows of a
    ``bucket``-row padded table, as the engine holds one."""
    rng = np.random.default_rng(seed)
    x = np.zeros((bucket, d))
    x[:n_live] = rng.random((n_live, d))
    y = np.zeros(bucket)
    y[:n_live] = rng.standard_normal(n_live)
    mask = np.arange(bucket) < n_live
    packed = np.concatenate([
        rng.normal(-1.0, 0.3, (S, d)),  # log lengthscales
        rng.normal(0.0, 0.2, (S, 1)),  # log amplitude
        np.full((S, 1), np.log(1e-3)),  # log noise
        rng.normal(0.0, 0.2, (S, 2 * d)),  # log warps a, b
    ], axis=1)
    t = lambda a, **kw: torch.as_tensor(a, device=device, **kw)
    params = GPHyperParams.unpack(t(packed), d)
    return fit_posterior_batch(t(x), t(y), params, t(mask))


def pending_near(seed, x0, rows, active, device="cpu"):
    """``rows`` pending rows, the first ``active`` of them live, each within
    the exclusion radius's reach of a refined point's path."""
    rng = np.random.default_rng(seed)
    pend = rng.random((rows, x0.shape[1]))
    pend[:active] = np.clip(x0.cpu().numpy()[:active] + 0.03, 0.0, 1.0)
    mask = np.arange(rows) < active
    return (torch.as_tensor(pend, device=device),
            torch.as_tensor(mask, device=device))


def eager(post, anchors, y_best, pending, pending_mask, cfg, key=None):
    """``optimize_acquisition`` with the eager ascent on any device."""
    k_ts, _ = prng.split(prng.PRNGKey(0) if key is None else key)

    def score(x, differentiable):
        return O._acq_values(post, x, y_best, cfg, k_ts,
                             differentiable=differentiable)

    masked = O._pending_masked(score, pending, pending_mask, cfg)
    return O._refine_and_rank(masked, anchors, cfg)


@pytest.fixture
def counters():
    """Telemetry on and empty; the counters the test's calls made."""
    tel = telemetry.get()
    was = tel.enabled
    tel.reset()
    tel.set_enabled(True)
    yield lambda: tel.metrics()["counters"]
    tel.set_enabled(was)
    tel.reset()


# ------------------------------------------------------------------ CPU

def test_expected_improvement_takes_a_0d_y_best_bit_for_bit():
    rng = np.random.default_rng(0)
    mu = torch.tensor(rng.standard_normal((10, 64)), requires_grad=True)
    var = torch.tensor(rng.random((10, 64)) * 2.0 + 1e-6, requires_grad=True)
    for y_best in (-1.2345678901234567, 0.0, 3.0e-9):
        outs = []
        for yb in (y_best, torch.tensor(y_best, dtype=torch.float64)):
            ei = A.expected_improvement(mu, var, yb)
            outs.append((ei, *torch.autograd.grad(ei.sum(), (mu, var))))
        for a, b in zip(*outs):
            assert torch.equal(a, b)


@pytest.mark.parametrize("acq", ["ei", "lcb"])
def test_scorer_takes_a_0d_y_best_bit_for_bit(acq):
    """The refinement's scorer and its gradient in x, as the ascent takes
    them, with ``y_best`` a float and a 0-d float64 tensor."""
    post = posterior(1, 11, 16, 4, 3)
    cfg = O.AcqOptConfig(acq=acq)
    x = torch.as_tensor(np.random.default_rng(2).random((8, 3)))
    y_best = -0.8765432109876543
    outs = []
    for yb in (y_best, torch.tensor(y_best, dtype=torch.float64)):
        xg = x.clone().requires_grad_(True)
        vals = O._acq_values(post, xg, yb, cfg, None, differentiable=True)
        outs.append((vals, *torch.autograd.grad(vals.sum(), xg)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("acq", ["ei", "lcb", "ts"])
def test_cpu_runs_the_eager_body_and_counts_it(counters, acq):
    post = posterior(3, 9, 16, 3, 4)
    anchors = torch.as_tensor(np.random.default_rng(4).random((64, 4)))
    pending, pmask = pending_near(5, anchors[:4], 8, 2)
    cfg = O.AcqOptConfig(acq=acq, num_anchors=64, num_refine=4, refine_steps=5,
                         backend="torch")
    graphs = dict(O._GRAPHS.entries)
    got = [O.optimize_acquisition(post, anchors, -0.5, pending, pmask,
                                  prng.PRNGKey(7), cfg) for _ in range(3)]
    assert counters() == {"acq.refine.eager": 3}
    assert O._GRAPHS.entries == graphs
    # the same call through the eager route, ascent left to its default
    want = eager(post, anchors, -0.5, pending, pmask, cfg, prng.PRNGKey(7))
    for x, v in got:
        assert torch.equal(x, want[0]) and torch.equal(v, want[1])


def _key(bucket=16, S=10, d=6, rows=64, refine=8, **cfg):
    post = posterior(0, 5, bucket, S, d)
    x0 = torch.zeros((refine, d), dtype=torch.float64)
    pending = torch.zeros((rows, d), dtype=torch.float64)
    statics = O._static_inputs(post, pending, torch.zeros(rows, dtype=torch.bool), x0)
    return O._graph_key(statics, O.AcqOptConfig(**cfg))


@pytest.mark.parametrize("change", [
    dict(bucket=32), dict(S=4), dict(d=5), dict(rows=3), dict(rows=0), dict(refine=4),
    dict(acq="lcb"), dict(refine_steps=24), dict(refine_lr=0.04),
    dict(lcb_kappa=1.5), dict(exclusion_radius=0.03),
])
def test_graph_key_tells_apart_what_a_capture_bakes_in(change):
    assert _key(**change) != _key()


def test_graph_key_ignores_data_and_what_the_ascent_does_not_read():
    assert _key() == _key()  # new tensors, same shapes
    assert _key(num_anchors=512, backend="torch") == _key()
    post = posterior(0, 5, 16, 10, 6)
    x0 = torch.zeros((8, 6), dtype=torch.float64)
    statics = O._static_inputs(post, torch.zeros((64, 6), dtype=torch.float64),
                               torch.zeros(64, dtype=torch.bool), x0)
    f32 = [t.float() if t.is_floating_point() else t for t in statics]
    assert O._graph_key(f32, O.AcqOptConfig()) != O._graph_key(statics, O.AcqOptConfig())
    # the factor's layout: column-major from the Cholesky, row-major after
    # an append
    assert statics[2].stride() != statics[2].contiguous().stride()
    rows = statics[:2] + [statics[2].contiguous()] + statics[3:]
    assert O._graph_key(rows, O.AcqOptConfig()) != O._graph_key(statics, O.AcqOptConfig())


class _Entry:
    def __init__(self, nbytes):
        self.nbytes = nbytes


def test_graph_cache_drops_the_least_recently_used_past_its_budget(counters):
    cache = O._GraphCache(budget_bytes=100)
    made = []

    def make(nbytes):
        def f():
            made.append(nbytes)
            return _Entry(nbytes)
        return f

    for key in "ab":
        cache.get(key, make(40))
        cache.bound(keep=key)
    assert list(cache.entries) == ["a", "b"]
    assert cache.get("a", make(99)).nbytes == 40  # a hit: now the most recent
    assert made == [40, 40] and list(cache.entries) == ["b", "a"]
    cache.get("c", make(30))
    cache.bound(keep="c")  # 110 bytes: b, the least recently used, goes
    assert list(cache.entries) == ["a", "c"]
    cache.get("d", make(500))
    cache.bound(keep="d")  # alone above the budget: kept, the rest go
    assert list(cache.entries) == ["d"]
    cache.bound(keep="d")
    assert counters() == {"acq.refine.graph.evict": 3}
    assert O._GRAPHS.budget_bytes == O.GRAPH_CACHE_BYTES


# ----------------------------------------------------------------- card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.fixture
def fresh_graphs():
    """An empty graph cache for the test, the process's restored after."""
    entries = O._GRAPHS.entries
    saved = dict(entries)
    entries.clear()
    yield entries
    entries.clear()
    entries.update(saved)


def _decision(seed, dev, n_live=50, bucket=64, active=3):
    """A posterior, anchors and a pending set with live rows, at the
    engine's shapes (S 10, d 6, 64 pending rows, 8 refined points)."""
    post = posterior(seed, n_live, bucket, 10, 6, dev)
    anchors = torch.as_tensor(np.random.default_rng(seed + 1).random((1024, 6)),
                              device=dev)
    pending, pmask = pending_near(seed + 2, anchors[:8], 64, active, dev)
    return post, anchors, -1.0 - 0.01 * seed, pending, pmask


def _graphed(post, anchors, y_best, pending, pmask, cfg):
    return O.optimize_acquisition(post, anchors, y_best, pending, pmask,
                                  prng.PRNGKey(0), cfg)


@pytest.mark.card
@pytest.mark.parametrize("acq", ["ei", "lcb"])
def test_replay_on_new_inputs_is_the_eager_loop_bit_for_bit(card, fresh_graphs, counters, acq):
    cfg = O.AcqOptConfig(acq=acq, backend="torch")
    a = _decision(10, card)
    got_a = _graphed(*a, cfg)  # warm-up and capture on A
    want_a = eager(*a, cfg)
    for b in (_decision(20, card), _decision(30, card, n_live=41, active=5)):
        got, want = _graphed(*b, cfg), eager(*b, cfg)
        assert not torch.equal(got[0], got_a[0])  # B's own points, not A's
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got_a[0], want_a[0]) and torch.equal(got_a[1], want_a[1])
    c = counters()
    assert (c["acq.refine.graph.capture"], c["acq.refine.graph.replay"]) == (1, 2)
    assert c["acq.refine.eager"] == 3  # the eager references
    assert len(fresh_graphs) == 1


@pytest.mark.card
@pytest.mark.parametrize("bucket", [64, 512])
@pytest.mark.parametrize("layout", ["cholesky", "rows"])
def test_ascent_replay_on_new_inputs_equals_the_eager_body(card, fresh_graphs, bucket, layout):
    """Stage 3 alone: the replay's x against ``_adam_ascent`` on the
    decision's own tensors, y_best a float, with the factor column-major
    (as the Cholesky leaves it) or row-major (as an append does); at 512
    rows the two layouts round the triangular solve differently."""
    cfg = O.AcqOptConfig(backend="torch")
    for seed in (40, 50, 60):
        post, anchors, y_best, pending, pmask = _decision(seed, card, bucket - 14, bucket)
        if layout == "rows":
            post = post._replace(chol=post.chol.contiguous())
        x0 = anchors[:8]
        got = O._graphed_ascent(post, y_best, pending, pmask, x0, cfg)

        def score(x, differentiable):
            return O._acq_values(post, x, y_best, cfg, None,
                                 differentiable=differentiable)

        want = O._adam_ascent(O._pending_masked(score, pending, pmask, cfg), x0, cfg)
        assert torch.equal(got, want)


@pytest.mark.card
def test_two_threads_replaying_one_key_get_their_own_results(card, fresh_graphs):
    cfg = O.AcqOptConfig(backend="torch")
    _graphed(*_decision(70, card), cfg)  # capture
    inputs = [_decision(80 + 10 * i, card) for i in range(2)]
    want = [eager(*b, cfg) for b in inputs]
    got = [[] for _ in inputs]

    def run(i):
        for _ in range(5):
            got[i].append(_graphed(*inputs[i], cfg))
        torch.cuda.synchronize()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(fresh_graphs) == 1
    for i in range(2):
        assert len(got[i]) == 5
        for x, v in got[i]:
            assert torch.equal(x, want[i][0]) and torch.equal(v, want[i][1])


@pytest.mark.card
def test_one_capture_then_replays_over_n_refinements(card, fresh_graphs, counters):
    cfg = O.AcqOptConfig(backend="torch")
    n = 6
    for i in range(n):
        _graphed(*_decision(100 + i, card), cfg)
    # a second bucket and a second setting are keys of their own
    _graphed(*_decision(200, card, n_live=100, bucket=128), cfg)
    _graphed(*_decision(201, card), cfg._replace(acq="lcb"))
    c = counters()
    assert c == {"acq.refine.graph.capture": 3, "acq.refine.graph.replay": n - 1}
    assert len(fresh_graphs) == 3


@pytest.mark.card
def test_thompson_stays_eager_on_the_card(card, fresh_graphs, counters):
    cfg = O.AcqOptConfig(acq="ts", backend="torch")
    _graphed(*_decision(300, card), cfg)
    assert counters() == {"acq.refine.eager": 1} and not fresh_graphs


@pytest.mark.card
def test_an_evicted_shape_captures_again(card, fresh_graphs, counters, monkeypatch):
    monkeypatch.setattr(O._GRAPHS, "budget_bytes", 0)  # one entry at a time
    cfg = O.AcqOptConfig(backend="torch")
    a, b = _decision(400, card), _decision(401, card, n_live=100, bucket=128)
    for dec in (a, b, a):
        got, want = _graphed(*dec, cfg), eager(*dec, cfg)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    c = counters()
    assert (c["acq.refine.graph.capture"], c["acq.refine.graph.evict"]) == (3, 2)
    assert "acq.refine.graph.replay" not in c and len(fresh_graphs) == 1


@pytest.mark.card
@pytest.mark.parametrize("bucket", [64, 512, 2048])
def test_an_entry_holds_its_copies_and_its_pool(card, fresh_graphs, bucket):
    """An entry's bytes: the copies of its inputs and the graph's pool.
    Prints the shape's first call (capture and replay) and a later replay,
    host clock around synchronized work, at S 10, d 6, 8 points, 64
    pending rows and 14 rows short of the bucket."""
    cfg = O.AcqOptConfig(backend="torch")
    _graphed(*_decision(500, card, n_live=6, bucket=8), cfg)  # the thread is warm
    post, anchors, y_best, pending, pmask = _decision(501, card, bucket - 14, bucket)
    x0 = anchors[:8]
    statics = O._static_inputs(post, pending, pmask, x0)
    ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        O._graphed_ascent(post, y_best, pending, pmask, x0, cfg)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
    entry = fresh_graphs[O._graph_key(statics, cfg)]
    copies = sum(t.nbytes for t in statics) + 8  # and y_best
    pool = entry.nbytes - copies
    assert pool > 0
    print(f"\nbucket {bucket}: first call {ms[0]:.1f} ms, replay {ms[1]:.1f} ms, "
          f"entry {entry.nbytes / 2**20:.2f} MiB ({copies / 2**20:.2f} copies, "
          f"{pool / 2**20:.2f} pool); {torch.cuda.get_device_name()}")
