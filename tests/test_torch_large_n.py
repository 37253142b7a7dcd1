"""The port's large-n posterior backend and per-head GPHP chains against the
JAX package's (twins of ``tests/test_large_n.py``).

Every case runs both packages on the same seeded stores, made with numpy,
at the reference tests' small sizes: ``_SUBSET`` is the reference's engine
(``n_switch=12``, ``max_inducing=10``, a 2-d space, the tiny chain), so the
inducing set is live in every invariance below. Tolerances:

* ``select_inducing``: the index arrays are equal (both are the same numpy
  operations; a near-tie of ``argmax`` would otherwise pick another row);
* suggestions and trial tables: the encoded configs to 1e-9 against the
  reference (the port's float64 torch numerics against XLA's);
* within the port — below ``n_switch`` against the exact backend, the
  rebuild after an eviction, eviction and snapshot restore — bit for bit;
* wire images and snapshot frames: equal bytes or equal objects.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import rpc as JR
from repro.core.gp.slice_sampler import SliceSamplerConfig as JSC
from repro.core.gp.sparse import select_inducing as j_select
from repro.core.optimize_acq import AcqOptConfig as JAcq
from repro.core.scheduler import SimBackend as JSim
import repro_torch.core as T
from repro_torch.core import rpc as TR
from repro_torch.core.gp.slice_sampler import SliceSamplerConfig as TSC
from repro_torch.core.gp.sparse import select_inducing
from repro_torch.core.optimize_acq import AcqOptConfig as TAcq
from repro_torch.core.scheduler import SimBackend as TSim
from repro_torch.distributed.engine_client import RemoteService, _Connection
from repro_torch.distributed.engine_server import EngineServer

torch.backends.cuda.matmul.allow_tf32 = False
# one thread a worker: at -n 6 torch's default pools oversubscribe the CPU
torch.set_num_threads(1)

PKG = {
    "jax": dict(C=J, SC=JSC, Acq=JAcq, Sim=JSim, R=JR, kw={},
                scoring={"torch": "xla", "kernel": "pallas"}),
    "torch": dict(C=T, SC=TSC, Acq=TAcq, Sim=TSim, R=TR, kw={"device": "cpu"},
                  scoring={"torch": "torch", "kernel": "kernel"}),
}
TOL = 1e-9


def _exact(pkg, **over):
    p = PKG[pkg]
    cfg = p["C"].BOConfig(
        num_init=3,
        slice_config=p["SC"](num_samples=4, burn_in=2, thin=1),
        refit_every=3,
        incremental=True,
        backend=p["scoring"]["torch"],
    )
    return dataclasses.replace(cfg, **over)


def _subset(pkg, **over):
    # the reference's _SUBSET: selection live from boundary 12, 10 rows
    return _exact(pkg, **{"posterior_backend": "subset", "n_switch": 12,
                          "max_inducing": 10, **over})


def _space(C):
    return C.SearchSpace([
        C.Continuous("x", 0.0, 1.0),
        C.Continuous("y", -1.0, 1.0),
    ])


def _obj(cfg):
    return float((cfg["x"] - 0.3) ** 2 + (cfg["y"] - 0.1) ** 2)


def _metrics(C):
    return C.MetricSet([
        C.MetricSpec("loss"),
        C.MetricSpec("lat", objective=False, threshold=0.9),
    ])


def _push(store, c):
    if store.num_metrics > 1:
        store.push_metrics(c, {"loss": _obj(c), "lat": c["x"] + c["y"]})
    else:
        store.push(c, _obj(c))


def _seeded_store(C, space, n, seed=3, metrics=None):
    store = C.ObservationStore(space, metrics=metrics)
    for c in space.sample(np.random.default_rng(seed), n):
        _push(store, c)
    return store


def _suggester(pkg, cfg, store, seed=5):
    p = PKG[pkg]
    return p["C"].BOSuggester(_space(p["C"]) if store is None else store.space,
                              cfg, seed=seed, store=store, **p["kw"])


def _drive(sug, store, steps):
    stream = []
    for _ in range(steps):
        c = sug.suggest_batch(1)[0]
        stream.append(c)
        _push(store, c)
    return stream


def _drive_handle(handle, steps, start=0):
    stream = []
    for i in range(start, start + steps):
        c = handle.suggest_batch(1)[0]
        stream.append(c)
        handle.store.mark_pending(i, c)
        handle.store.clear_pending(i)
        handle.store.push(c, _obj(c))
    return stream


def _service(pkg, **conf):
    p = PKG[pkg]
    return p["C"].SelectionService(p["C"].ServiceConfig(**conf), **p["kw"])


def _enc(configs):
    return np.array([[c["x"], c["y"]] for c in configs])


def _close(got, want):
    np.testing.assert_allclose(_enc(got), _enc(want), rtol=0, atol=TOL)


def _job_stream(pkg, cfg, n0=20, steps=6, metrics=False):
    C = PKG[pkg]["C"]
    space = _space(C)
    store = _seeded_store(C, space, n0, metrics=_metrics(C) if metrics else None)
    sug = _suggester(pkg, cfg, store)
    return _drive(sug, store, steps), sug


# ------------------------------------------------------- inducing selection


def _x_cases():
    rng = np.random.default_rng(0)
    clusters = np.random.default_rng(2)
    return {
        "random": (rng.random((200, 3)), 32),
        "small_n": (np.random.default_rng(1).random((5, 2)), 8),
        "n_equals_m": (np.random.default_rng(1).random((5, 2)), 5),
        "duplicates": (np.repeat(
            np.array([[0.0, 0.0], [1.0, 1.0], [0.5, 0.0]]), 10, axis=0), 6),
        "clusters": (np.concatenate([
            clusters.normal(0.0, 0.01, (50, 2)),
            clusters.normal(10.0, 0.01, (50, 2)),
        ]), 4),
        "ties_on_grid": (np.stack(np.meshgrid(
            np.linspace(0, 1, 9), np.linspace(0, 1, 9)), -1).reshape(-1, 2), 17),
        "store_10k_6d": (np.random.default_rng(7).random((10_000, 6)), 64),
    }


@pytest.mark.parametrize("case", list(_x_cases()))
def test_select_inducing_equals_reference(case):
    x, m = _x_cases()[case]
    got = select_inducing(x, m)
    want = j_select(x, m)
    assert got.dtype == want.dtype == np.int64
    assert np.array_equal(got, want)
    assert len(got) == min(m, len(x))
    assert np.all(np.diff(got) > 0)  # sorted ascending, no repeats
    assert np.array_equal(select_inducing(x.copy(), m), got)  # deterministic


def test_select_inducing_properties():
    x = np.random.default_rng(1).random((5, 2))
    assert np.array_equal(select_inducing(x, 8), np.arange(5))
    x, m = _x_cases()["duplicates"]
    assert len(set(select_inducing(x, m).tolist())) == 6
    x, m = _x_cases()["clusters"]
    sel = select_inducing(x, m)
    assert np.any(sel < 50) and np.any(sel >= 50)
    for sel_fn in (select_inducing, j_select):
        with pytest.raises(ValueError):
            sel_fn(np.zeros((4, 2)), 0)


# ----------------------------------------------- exact-path bit-equivalence


def test_subset_below_switch_bit_identical_in_process():
    """Below n_switch the subset backend is the exact engine bit for bit;
    both equal the reference's stream to 1e-9."""
    exact, _ = _job_stream("torch", _exact("torch"), n0=8, steps=6)
    high, sug = _job_stream("torch", _subset("torch", n_switch=4096), n0=8, steps=6)
    assert high == exact
    assert sug.cache.inducing_sel is None
    want, _ = _job_stream("jax", _subset("jax", n_switch=4096), n0=8, steps=6)
    _close(high, want)


def test_subset_below_switch_bit_identical_over_socket():
    """Over the port's socket pair, a job declared with the subset backend
    (below the switch) gives the in-process exact engine's stream exactly —
    which pins the subset fields of the config's wire image too."""
    space = _space(T)
    h = _service("torch").register_job("job", space, bo_config=_exact("torch"), seed=5)
    ref = _drive_handle(h, 6)
    with EngineServer(device="cpu") as server:
        rsvc = RemoteService([server.address])
        rh = rsvc.register_job("job", space, bo_config=_subset("torch", n_switch=4096),
                               seed=5)
        got = _drive_handle(rh, 6)
        rh.close()
    assert got == ref


# ----------------------------------------------------------- subset engine


@pytest.mark.parametrize("n0", [8, 20])
def test_subset_stream_equals_reference(n0):
    """Below (8 rows) and above (20 rows) the switch: the port's suggestions
    and inducing set equal the reference's."""
    got, ts = _job_stream("torch", _subset("torch"), n0=n0, steps=6)
    want, js = _job_stream("jax", _subset("jax"), n0=n0, steps=6)
    _close(got, want)
    if js.cache.inducing_sel is None:
        assert ts.cache.inducing_sel is None
    else:
        assert np.array_equal(ts.cache.inducing_sel, js.cache.inducing_sel)
        assert ts.cache.inducing_n0 == js.cache.inducing_n0


def _tuner(pkg, cfg, trials=16, parallel=3, metrics=False, service=None):
    p = PKG[pkg]
    C = p["C"]
    space = _space(C)
    warm = None  # multi-metric stores fold no parents
    if not metrics:
        warm = C.WarmStartPool()
        rng = np.random.default_rng(11)
        warm.add_parent([(c, _obj(c)) for c in space.sample(rng, 14)],
                        name="parent")

    def objective(c):
        curve = _obj(c) + 0.5 * np.exp(-0.4 * np.arange(1, 6))
        if metrics:
            return curve, 1.0, {"loss": _obj(c), "lat": c["x"] + c["y"]}
        return curve, 1.0

    job = C.TuningJobConfig(max_trials=trials, max_parallel=parallel, seed=3,
                            metrics=tuple(_metrics(C).specs) if metrics else None)
    sug = C.BOSuggester(space, cfg, seed=0, **p["kw"])
    return C.Tuner(space, objective, sug, p["Sim"](startup_cost=2.0), job,
                   warm_start=warm)


def _table(result):
    return [(t.trial_id, str(t.state), t.objective) for t in result.trials], \
        np.array([[t.config["x"], t.config["y"]] for t in result.trials])


@pytest.mark.parametrize("over", [
    dict(pending_strategy="liar"),
    dict(pending_strategy="kb", refit_every=4),
], ids=["liar", "kb"])
def test_subset_tuner_trial_table_twin(over):
    """A Tuner on a 14-row warm start (the boundary selects from its first
    refit), 3 slots: the trial table equals the reference's to 1e-9 —
    pending fantasies and rank-1 appends run against the live rows."""
    tuner = _tuner("torch", _subset("torch", **over))
    tr = tuner.run()
    assert tuner.suggester.cache.inducing_sel is not None
    jr = _tuner("jax", _subset("jax", **over)).run()
    (tt, tx), (jt, jx) = _table(tr), _table(jr)
    assert [r[:2] for r in tt] == [r[:2] for r in jt]
    np.testing.assert_allclose(tx, jx, rtol=0, atol=TOL)
    np.testing.assert_allclose([r[2] for r in tt], [r[2] for r in jt], rtol=0, atol=TOL)


def test_rebuild_replays_boundary_factorization_bit_exact():
    """drop_factors → the next decision re-selects over the boundary prefix,
    factorizes and replays the appends: L, L⁻¹-free alpha and the set come
    back bit for bit, and the set is the reference's."""
    space = _space(T)
    store = _seeded_store(T, space, 20)
    sug = _suggester("torch", _subset("torch"), store)
    _drive(sug, store, 2)  # past a boundary + appends
    sug.suggest_batch(1)  # factors now cover every store row
    assert sug.cache.inducing_sel is not None
    before = sug.cache.post
    sel_before = sug.cache.inducing_sel.copy()
    sug.cache.drop_factors()
    sug.suggest_batch(1)  # same store state: pure rebuild
    after = sug.cache.post
    assert torch.equal(before.chol, after.chol)
    assert torch.equal(before.alpha, after.alpha)
    assert torch.equal(before.x_train, after.x_train)
    assert np.array_equal(sel_before, sug.cache.inducing_sel)

    jspace = _space(J)
    jstore = _seeded_store(J, jspace, 20)
    jsug = _suggester("jax", _subset("jax"), jstore)
    _drive(jsug, jstore, 2)
    jsug.suggest_batch(1)
    assert np.array_equal(jsug.cache.inducing_sel, sel_before)
    np.testing.assert_allclose(before.chol.numpy(), np.asarray(jsug.cache.post.chol),
                               rtol=0, atol=TOL)


def _eviction_run(pkg, budget_mb):
    C = PKG[pkg]["C"]
    space = _space(C)
    svc = _service(pkg, arena_budget_mb=budget_mb)
    h1 = svc.register_job("a", space, bo_config=_subset(pkg), seed=5)
    h2 = svc.register_job("b", space, bo_config=_subset(pkg), seed=9)
    for c in space.sample(np.random.default_rng(3), 18):
        h1.store.push(c, _obj(c))
        h2.store.push(c, _obj(c) + 0.1)
    stream = []
    for _ in range(4):
        c1 = h1.suggest_batch(1)[0]
        h1.store.push(c1, _obj(c1))
        c2 = h2.suggest_batch(1)[0]
        h2.store.push(c2, _obj(c2) + 0.1)
        stream.extend([c1, c2])
    return stream, svc


def test_eviction_invariant_suggestions():
    """Tight vs roomy arena: the same subset-backend streams bit for bit
    (evictions replay the inducing construction RNG-free), the reference's
    streams to 1e-9 and the reference's eviction count."""
    tight, svc_t = _eviction_run("torch", 1e-6)
    roomy, svc_r = _eviction_run("torch", 1024.0)
    assert svc_t.arena.evictions > 0
    assert svc_r.arena.evictions == 0
    assert tight == roomy
    jtight, jsvc = _eviction_run("jax", 1e-6)
    _close(tight, jtight)
    assert svc_t.arena.evictions == jsvc.arena.evictions


def _subset_snapshot(pkg):
    C = PKG[pkg]["C"]
    space = _space(C)
    svc = _service(pkg)
    h = svc.register_job("job", space, bo_config=_subset(pkg), seed=5)
    for c in space.sample(np.random.default_rng(3), 18):
        h.store.push(c, _obj(c))
    _drive_handle(h, 2, start=100)
    snap = json.loads(json.dumps(svc.snapshot_job("job")))
    return h, snap


@pytest.mark.parametrize("src,dst", [("torch", "torch"), ("jax", "torch"),
                                     ("torch", "jax")])
def test_snapshot_restore_subset_active(src, dst):
    """A snapshot taken with the inducing set live restores in either
    package and continues the stream (bit for bit within the port, 1e-9
    across packages); both packages write the same set."""
    h, snap = _subset_snapshot(src)
    assert snap["cache"]["inducing_sel"] is not None
    expected = _drive_handle(h, 3, start=200)
    rh = _service(dst).restore_job(snap)
    got = _drive_handle(rh, 3, start=200)
    if src == dst:
        assert got == expected
    else:
        _close(got, expected)
    _, other = _subset_snapshot("jax" if src == "torch" else "torch")
    assert other["cache"]["inducing_sel"] == snap["cache"]["inducing_sel"]
    assert other["cache"]["inducing_n0"] == snap["cache"]["inducing_n0"]


def test_state_dict_roundtrip_subset_active():
    """state_dict round-trips within the port, and the reference's loads."""
    space = _space(T)
    s1 = _suggester("torch", _subset("torch"), _seeded_store(T, space, 20))
    s1.suggest_batch(1)
    state = json.loads(json.dumps(s1.state_dict()))
    a = s1.suggest_batch(1)
    s2 = _suggester("torch", _subset("torch"), _seeded_store(T, space, 20))
    s2.suggest_batch(1)
    s2.load_state_dict(state)
    assert s2.suggest_batch(1) == a

    j1 = _suggester("jax", _subset("jax"), _seeded_store(J, _space(J), 20))
    j1.suggest_batch(1)
    jstate = json.loads(json.dumps(j1.state_dict()))
    assert jstate.keys() == state.keys()
    s3 = _suggester("torch", _subset("torch"), _seeded_store(T, space, 20))
    s3.load_state_dict(jstate)
    _close(s3.suggest_batch(1), j1.suggest_batch(1))


def test_kernel_scoring_matches_torch_at_subset_shapes():
    """The fused scoring backend takes the subset-sized factor unchanged:
    "kernel" picks the same candidates as "torch" (on the CPU the kernel's
    wrapper runs its plain version; the card holds the kernel itself)."""
    k, _ = _job_stream("torch", _subset("torch", backend="kernel"), steps=4)
    t, _ = _job_stream("torch", _subset("torch"), steps=4)
    assert k == t


# -------------------------------------------------- arena budget end-to-end


def test_stats_report_factor_and_store_bytes():
    """The arena's stats count the subset factor and the store, as the
    reference's do (the same bytes: the same leaves and dtypes)."""
    stats = {}
    for pkg in ("jax", "torch"):
        C = PKG[pkg]["C"]
        space = _space(C)
        svc = _service(pkg, arena_budget_mb=1024.0)
        h = svc.register_job("job", space, bo_config=_subset(pkg), seed=5)
        for c in space.sample(np.random.default_rng(3), 14):
            h.store.push(c, _obj(c))
        h.suggest_batch(1)
        stats[pkg] = svc.arena.stats()
    s = stats["torch"]
    assert s["store_bytes"] > 0 and s["factor_bytes"] > 0
    assert s["resident_bytes"] == s["factor_bytes"] + s["store_bytes"]
    assert s == stats["jax"]


def test_resident_bytes_stay_under_budget_multi_job():
    """A budget between one and two jobs' factor residency (above the store
    floor): the arena evicts, resident bytes stay under it after every
    decision, and the streams do not change."""

    def run(budget_mb, sample=False):
        space = _space(T)
        svc = _service("torch", arena_budget_mb=budget_mb)
        handles = [
            svc.register_job(f"j{k}", space, bo_config=_subset("torch"), seed=5 + k)
            for k in range(2)
        ]
        for c in space.sample(np.random.default_rng(3), 18):
            for k, h in enumerate(handles):
                h.store.push(c, _obj(c) + 0.1 * k)
        stream, samples = [], []
        for _ in range(4):
            for k, h in enumerate(handles):
                c = h.suggest_batch(1)[0]
                h.store.push(c, _obj(c) + 0.1 * k)
                stream.append(c)
                if sample:
                    samples.append(svc.arena.resident_bytes())
        return stream, samples, svc

    roomy, _, svc_r = run(1024.0)
    per_job_factor = max(c.factor_nbytes() for c in svc_r.arena._entries.values())
    budget = svc_r.arena.store_bytes() + int(1.5 * per_job_factor)
    tight, samples, svc_t = run(budget / 2**20, sample=True)
    assert svc_t.arena.evictions > 0
    assert tight == roomy
    assert max(samples) <= budget
    assert svc_t.arena.budget_bytes == budget


# -------------------------------------------------- chunked snapshot frames


_SNAP = {"rows": list(range(500)), "blob": "x" * 4096, "f": 0.1}


def test_frames_equal_bytes_and_decode_across_packages():
    for size in (64, 1 << 20):
        frames = TR.encode_snapshot_frames(_SNAP, "zlib", size)
        assert frames == JR.encode_snapshot_frames(_SNAP, "zlib", size)
        assert (len(frames) > 1) == (size == 64)
        assert JR.decode_snapshot_frames(frames, "zlib") == _SNAP
        assert TR.decode_snapshot_frames(frames, "zlib") == _SNAP
    single = TR.encode_snapshot_frame(_SNAP, "zlib")
    assert single == JR.encode_snapshot_frame(_SNAP, "zlib")
    assert JR.decode_snapshot_frame(single, "zlib") == _SNAP
    assert TR.available_snapshot_codecs() == JR.available_snapshot_codecs()


def test_frames_reject_bad_inputs():
    with pytest.raises(ValueError):
        TR.encode_snapshot_frames({}, "zlib", 0)
    with pytest.raises(ValueError):
        TR.encode_snapshot_frames({}, "nope", 64)
    with pytest.raises(ValueError):
        TR.decode_snapshot_frames(["aa"], "nope")


def test_server_chunks_when_asked():
    """Raw-socket check of the chunked reply shape on the port's replica;
    the reference's codec decodes its frames."""
    space = _space(T)
    with EngineServer(device="cpu") as server:
        conn = _Connection(server.address, 5.0, 60.0)
        reply = conn.call(TR.RegisterRequest(
            job_name="job", space_spec=space.to_spec(), seed=5,
            bo_config=TR.bo_config_to_wire(_exact("torch")),
        ))
        plain = conn.call(TR.SnapshotRequest(job_name="job", lease=reply.lease))
        chunked = conn.call(TR.SnapshotRequest(
            job_name="job", lease=reply.lease,
            accept_codecs=["zlib"], max_frame_bytes=128,
        ))
        conn.close()
    assert isinstance(chunked, TR.SnapshotReply)
    assert chunked.frames is not None and len(chunked.frames) > 1
    assert JR.decode_snapshot_frames(chunked.frames, chunked.codec) == plain.snapshot


def test_remote_service_chunked_stream_identical():
    """A client fetching its failover baseline in chunked frames gives the
    in-process stream exactly, and the reference's to 1e-9."""
    space = _space(T)
    h = _service("torch").register_job("job", space, bo_config=_exact("torch"), seed=5)
    ref = _drive_handle(h, 6)
    with EngineServer(device="cpu") as server:
        rsvc = RemoteService([server.address], snapshot_every=3,
                             snapshot_frame_bytes=512)
        rh = rsvc.register_job("job", space, bo_config=_exact("torch"), seed=5)
        got = _drive_handle(rh, 6)
        rh.close()
    assert got == ref
    jh = _service("jax").register_job("job", _space(J), bo_config=_exact("jax"), seed=5)
    _close(got, _drive_handle(jh, 6))


def test_subset_failover_over_chunked_frames():
    """The subset job fails over: two port replicas, the first shut down
    mid-stream; the handle restores the chunked snapshot on the second,
    replays its log and continues the uninterrupted stream exactly."""
    space = _space(T)
    cfg = _subset("torch")
    h = _service("torch").register_job("job", space, bo_config=cfg, seed=5)
    for c in space.sample(np.random.default_rng(3), 14):
        h.store.push(c, _obj(c))
    ref = _drive_handle(h, 6)
    s1 = EngineServer(device="cpu").start()
    s2 = EngineServer(device="cpu").start()
    try:
        rsvc = RemoteService([s1.address, s2.address], snapshot_every=4,
                             snapshot_frame_bytes=256)
        rh = rsvc.register_job("job", space, bo_config=cfg, seed=5)
        for c in space.sample(np.random.default_rng(3), 14):
            rh.store.push(c, _obj(c))
        got = _drive_handle(rh, 3)
        s1.shutdown()
        if rh._conn is not None:  # SIGKILL: the live connection dies too
            rh._conn.close()
        got += _drive_handle(rh, 3, start=3)
        assert s2.service.job("job").suggester.cache.inducing_sel is not None
        rh.close()
    finally:
        s2.shutdown()
    assert got == ref


@pytest.mark.slow
def test_large_store_chunked_restore_fresh_process(tmp_path):
    """n = 10⁴ store with the subset backend → snapshot → chunked zlib
    frames → a fresh interpreter of the port decodes, restores (re-selecting
    the inducing set) and continues the stream exactly."""
    space = _space(T)
    cfg = _subset("torch", n_switch=512, max_inducing=64, refit_every=64)
    h = _service("torch").register_job("job", space, bo_config=cfg, seed=5)
    xs = np.random.default_rng(3).random((10_000, 2))
    xs[:, 1] = 2.0 * xs[:, 1] - 1.0
    for i in range(10_000):
        h.store.push_encoded(
            space.encode({"x": float(xs[i, 0]), "y": float(xs[i, 1])}),
            float((xs[i, 0] - 0.3) ** 2 + (xs[i, 1] - 0.1) ** 2),
        )
    c = h.suggest_batch(1)[0]
    h.store.push(c, _obj(c))
    snap = h.service.snapshot_job("job")
    frames = TR.encode_snapshot_frames(snap, "zlib", 64 << 10)
    assert len(frames) > 1
    frames_path = tmp_path / "frames.json"
    frames_path.write_text(json.dumps(frames))
    expected = h.suggest_batch(1)[0]

    child = (
        "import json, sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from repro_torch.core.rpc import decode_snapshot_frames\n"
        "from repro_torch.core.service import SelectionService, ServiceConfig\n"
        "snap = decode_snapshot_frames(json.load(open(sys.argv[1])), 'zlib')\n"
        "h = SelectionService(ServiceConfig(), device='cpu').restore_job(snap)\n"
        "print(json.dumps(h.suggest_batch(1)[0]))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"
    )
    proc = subprocess.run(
        [sys.executable, "-c", child, str(frames_path)],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == expected


# ---------------------------------------------------------- config wire


def test_config_wire_new_fields_twin():
    tblob = json.loads(json.dumps(TR.bo_config_to_wire(_subset("torch"))))
    jblob = json.loads(json.dumps(JR.bo_config_to_wire(_subset("jax"))))
    assert tblob == jblob
    assert TR.bo_config_from_wire(jblob) == _subset("torch")
    assert JR.bo_config_from_wire(tblob) == _subset("jax")
    on = _exact("torch", per_head_gphp=True)
    assert TR.bo_config_from_wire(JR.bo_config_to_wire(_exact("jax", per_head_gphp=True))) == on


def test_config_wire_old_blob_gets_defaults():
    blob = TR.bo_config_to_wire(_exact("torch"))
    for key in ("posterior_backend", "n_switch", "max_inducing", "per_head_gphp"):
        del blob[key]
    cfg = TR.bo_config_from_wire(blob)
    assert cfg.posterior_backend == "exact"
    assert cfg.n_switch == 2048
    assert cfg.max_inducing == 1024
    assert cfg.per_head_gphp is False


def test_config_backend_validated_twin():
    for pkg in ("jax", "torch"):
        with pytest.raises(ValueError):
            dataclasses.replace(_exact(pkg), posterior_backend="vortex")
        with pytest.raises(ValueError):
            dataclasses.replace(_exact(pkg), max_inducing=1)


# ---------------------------------------------------------- per-head GPHPs


def test_per_head_m1_is_a_noop():
    """One metric has no extra heads: per_head_gphp=True is the default path
    bit for bit."""
    a, _ = _job_stream("torch", _exact("torch"), n0=8, steps=5)
    b, sug = _job_stream("torch", _exact("torch", per_head_gphp=True), n0=8, steps=5)
    assert a == b
    assert sug.cache.head_samples is None


@pytest.mark.parametrize("over", [{}, dict(posterior_backend="subset", n_switch=12,
                                           max_inducing=10)], ids=["exact", "subset"])
def test_per_head_constrained_equals_reference(over):
    """M = 2 constrained job: each head runs its own chain (one key per head,
    after the objective's) and the port's stream equals the reference's to
    1e-9; it differs from the shared-factor stream (the flag is live)."""
    got, ts = _job_stream("torch", _exact("torch", per_head_gphp=True, **over),
                          n0=14, steps=4, metrics=True)
    want, js = _job_stream("jax", _exact("jax", per_head_gphp=True, **over),
                           n0=14, steps=4, metrics=True)
    _close(got, want)
    assert len(ts.cache.head_samples) == 1
    np.testing.assert_allclose(ts.cache.head_samples[0], js.cache.head_samples[0],
                               rtol=0, atol=TOL)
    shared, _ = _job_stream("torch", _exact("torch", **over), n0=14, steps=4,
                            metrics=True)
    assert shared != got


def test_per_head_tuner_trial_table_twin():
    """A constrained Tuner with per-head chains and 3 slots under the
    constant liar: the heads' factors take the fantasies too; the trial
    table equals the reference's to 1e-9."""
    tr = _tuner("torch", _exact("torch", per_head_gphp=True, pending_strategy="liar"),
                trials=12, metrics=True).run()
    jr = _tuner("jax", _exact("jax", per_head_gphp=True, pending_strategy="liar"),
                trials=12, metrics=True).run()
    (tt, tx), (jt, jx) = _table(tr), _table(jr)
    assert [r[:2] for r in tt] == [r[:2] for r in jt]
    np.testing.assert_allclose(tx, jx, rtol=0, atol=TOL)


def test_per_head_state_roundtrip():
    """The per-head chain states and draws round-trip through state_dict in
    the port, and the reference's state_dict loads into the port."""
    on = {pkg: _exact(pkg, per_head_gphp=True) for pkg in PKG}

    def mk(pkg):
        C = PKG[pkg]["C"]
        return _suggester(pkg, on[pkg], _seeded_store(C, _space(C), 8, metrics=_metrics(C)))

    s1 = mk("torch")
    s1.suggest_batch(1)
    state = json.loads(json.dumps(s1.state_dict()))
    assert state["head_chain_states"] and state["cached_head_samples"]
    a = s1.suggest_batch(1)
    s2 = mk("torch")
    s2.suggest_batch(1)
    s2.load_state_dict(state)
    assert s2.suggest_batch(1) == a

    j1 = mk("jax")
    j1.suggest_batch(1)
    jstate = json.loads(json.dumps(j1.state_dict()))
    assert jstate.keys() == state.keys()
    s3 = mk("torch")
    s3.load_state_dict(jstate)
    _close(s3.suggest_batch(1), j1.suggest_batch(1))


def test_per_head_rebuild_after_drop_factors():
    """Per-head factors depend on X only: an eviction after every decision
    rebuilds them RNG-free and the stream does not change; it is the
    reference's to 1e-9."""

    def run(pkg, drop):
        C = PKG[pkg]["C"]
        store = _seeded_store(C, _space(C), 8, metrics=_metrics(C))
        sug = _suggester(pkg, _exact(pkg, per_head_gphp=True), store)
        out = []
        for _ in range(4):
            c = sug.suggest_batch(1)[0]
            out.append(c)
            _push(store, c)
            if drop:
                sug.cache.drop_factors()
                assert sug.cache.head_posts is None
        return out, sug

    kept, sug = run("torch", False)
    dropped, _ = run("torch", True)
    assert kept == dropped
    _close(kept, run("jax", True)[0])
    # the arena counts the head factors as the reference does
    jkept, jsug = run("jax", False)
    assert sug.cache.factor_nbytes() == jsug.cache.factor_nbytes() > 0


def test_per_head_snapshot_restores_across_packages():
    """An engine snapshot of a per-head job (head draws in the cache image)
    restores in the other package and continues to 1e-9."""
    for src, dst in (("jax", "torch"), ("torch", "jax")):
        C = PKG[src]["C"]
        space = _space(C)
        svc = _service(src)
        h = svc.register_job("job", space, bo_config=_exact(src, per_head_gphp=True),
                             seed=5, metrics=_metrics(C))
        for c in space.sample(np.random.default_rng(3), 8):
            _push(h.store, c)
        for _ in range(2):
            _push(h.store, h.suggest_batch(1)[0])
        snap = json.loads(json.dumps(svc.snapshot_job("job")))
        assert snap["cache"]["head_samples"] is not None
        rh = _service(dst).restore_job(snap)
        for _ in range(2):
            want, got = h.suggest_batch(1)[0], rh.suggest_batch(1)[0]
            _close([got], [want])
            _push(h.store, want)
            _push(rh.store, want)
