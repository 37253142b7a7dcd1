"""The port's wire protocol and socket replicas against the JAX package's
(twins of ``tests/test_remote_service.py`` and the wire half of
``tests/test_telemetry.py``).

The schema-drift rule of the linter reads only the reference's
``rpc.py``, so the schema twin here holds the port's messages to it: the
same message classes, tags, field names, field order and defaults, and the
same bytes for the same message, each package decoding the other's.

The socket cases run the port's ``RemoteService`` against the port's
``EngineServer`` (engines on the CPU): the suggestion stream and the trial
table equal the port's in-process ``SelectionService`` bit for bit (the wire
is exact), and the reference's in-process run to 1e-9 (the port's float64
torch numerics against XLA's). Failover after a replica dies mid-stream
keeps the stream exact with no failed attempts. Leases use short TTLs or an
injected clock, so no case waits out a 30 s TTL.
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import rpc as JR
from repro.core import telemetry as jtelemetry
from repro.core.gp.slice_sampler import SliceSamplerConfig as JSC
from repro.core.scheduler import SimBackend as JSim
from repro.distributed.engine_client import RemoteService as JRemote
from repro.distributed.engine_server import EngineServer as JServer
import repro_torch.core as T
from repro_torch.core import rpc as TR
from repro_torch.core import telemetry
from repro_torch.core.gp.slice_sampler import SliceSamplerConfig as TSC
from repro_torch.core.scheduler import SimBackend as TSim
from repro_torch.distributed.engine_client import (
    RemoteService,
    RemoteServiceError,
    ReplicaDivergenceError,
    _Connection,
)
from repro_torch.distributed.engine_server import EngineServer

torch.backends.cuda.matmul.allow_tf32 = False
# one thread a worker: at -n 6 torch's default pools oversubscribe the CPU
torch.set_num_threads(1)

TOL = 1e-9
PKG = {
    "jax": dict(C=J, SC=JSC, Sim=JSim, kw={}, backend="xla"),
    "torch": dict(C=T, SC=TSC, Sim=TSim, kw={"device": "cpu"}, backend="torch"),
}


def _cfg(pkg="torch", **over):
    p = PKG[pkg]
    return p["C"].BOConfig(
        num_init=3,
        slice_config=p["SC"](num_samples=4, burn_in=2, thin=1),
        refit_every=3,
        incremental=True,
        backend=p["backend"],
        **over,
    )


_CFG = _cfg()


def _space(C=T):
    return C.SearchSpace([
        C.Continuous("x", 0.0, 1.0),
        C.Continuous("y", -1.0, 1.0),
    ])


def _obj(cfg):
    return float((cfg["x"] - 0.3) ** 2 + (cfg["y"] - 0.1) ** 2)


def _drive(handle, steps, start=0):
    """suggest → pending → clear → push loop; returns the suggestion stream."""
    stream = []
    for i in range(start, start + steps):
        c = handle.suggest_batch(1)[0]
        stream.append(c)
        handle.store.mark_pending(i, c)
        handle.store.clear_pending(i)
        handle.store.push(c, _obj(c))
    return stream


def _service(pkg="torch", **conf):
    p = PKG[pkg]
    return p["C"].SelectionService(p["C"].ServiceConfig(**conf), **p["kw"])


def _server(**kw):
    return EngineServer(device="cpu", **kw)


def _close(got, want):
    enc = lambda cs: np.array([[c["x"], c["y"]] for c in cs])  # noqa: E731
    np.testing.assert_allclose(enc(got), enc(want), rtol=0, atol=TOL)


def _reference_stream(steps, seed=5, start=0, pre=0):
    h = _service("jax").register_job("job", _space(J), bo_config=_cfg("jax"), seed=seed)
    if pre:
        _drive(h, pre)
    return _drive(h, steps, start=start)


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ------------------------------------------------------------- the schema


def _message_classes(R):
    return {cls.TYPE: cls for cls in R._REGISTRY.values()}


def test_message_schema_twin():
    """Every message dataclass: the same tag, field names in the same order,
    the same defaults; the same versions, codes and exports."""
    tm, jm = _message_classes(TR), _message_classes(JR)
    assert list(tm) == list(jm)
    for tag, jcls in jm.items():
        tcls = tm[tag]
        assert tcls.__name__ == jcls.__name__
        tf, jf = dataclasses.fields(tcls), dataclasses.fields(jcls)
        assert [f.name for f in tf] == [f.name for f in jf], tag
        for a, b in zip(tf, jf):
            assert a.default == b.default, (tag, a.name)
            assert (a.default_factory is dataclasses.MISSING) == (
                b.default_factory is dataclasses.MISSING), (tag, a.name)
    assert TR.PROTOCOL_VERSION == JR.PROTOCOL_VERSION == 6
    assert TR.ENGINE_SNAPSHOT_VERSION == JR.ENGINE_SNAPSHOT_VERSION
    codes = lambda R: {k: v for k, v in vars(R.ErrorCode).items() if k.isupper()}  # noqa: E731
    assert codes(TR) == codes(JR)
    assert TR.__all__ == JR.__all__


def _sample_messages(R, space, cfg):
    from repro.core.gp.serialize import array_to_wire

    x = array_to_wire(np.array([0.25, 0.5]))
    ys = array_to_wire(np.array([1.5, -0.25]))
    return [
        R.RegisterRequest(job_name="job", space_spec=space.to_spec(), seed=5,
                          bo_config=R.bo_config_to_wire(cfg),
                          metric_specs=[{"name": "loss"}], max_cost=9.5,
                          capabilities=["snapshot-zlib"]),
        R.RegisterReply(lease="t", lease_ttl=30.0, num_parents=2, pool_version=3,
                        store_fingerprint="ab", capabilities=["snapshot-zlib"]),
        R.SuggestBatchRequest(job_name="j", lease="t", k=2, store_version=3,
                              num_pending=1),
        R.SuggestBatchReply(configs=[{"x": 0.1, "y": -0.2}], pool_version=4),
        R.ObserveRequest(job_name="j", lease="t", kind="push", x=x, y=0.125,
                         key=7, cost=1.5),
        R.ObserveRequest(job_name="j", lease="t", kind="push", x=x, ys=ys),
        R.ObserveReply(accepted=True, store_version=9),
        R.ReportRungRequest(job_name="j", lease="t", key=3, iteration=4, value=0.5),
        R.ReportRungReply(decision="stop", rung=1),
        R.PromotionRequest(job_name="j", lease="t"),
        R.PromotionReply(state={"rungs": [[1, 0.5]]}),
        R.HeartbeatRequest(job_name="j", lease="t"),
        R.HeartbeatReply(lease_ttl=1.5, pool_version=2),
        R.SnapshotRequest(job_name="j", lease="t", include_factors=True,
                          accept_codecs=["zlib"], max_frame_bytes=512),
        R.SnapshotReply(snapshot={}, codec="zlib", frames=["eJw=", "AA=="]),
        R.EngineStateRequest(job_name="j", lease="t"),
        R.EngineStateReply(state={"key": [0, 5]}),
        R.EngineRestoreRequest(job_name="j", lease="t", suggester_state={"a": 1}),
        R.EngineRestoreReply(),
        R.MetricsRequest(),
        R.MetricsReply(metrics={"enabled": False}, service_stats={"jobs": 1}),
        R.ErrorReply(code=R.ErrorCode.LEASE_HELD, message="held", retry_after=2.5),
    ]


@pytest.mark.parametrize("i", range(22))
def test_message_bytes_twin(i):
    """The same message encodes to the same bytes in both packages, and each
    package decodes the other's bytes to an equal message."""
    tmsg = _sample_messages(TR, _space(T), _CFG)[i]
    jmsg = _sample_messages(JR, _space(J), _cfg("jax"))[i]
    tb, jb = TR.encode_message(tmsg), JR.encode_message(jmsg)
    assert tb == jb
    assert TR.decode_message(jb) == tmsg
    assert JR.decode_message(tb) == jmsg


def test_codec_roundtrip_and_bad_input():
    msg = TR.SuggestBatchRequest(job_name="j", lease="t", k=2, store_version=3,
                                 num_pending=1)
    assert TR.decode_message(TR.encode_message(msg)) == msg
    with pytest.raises(TR.ProtocolError):
        TR.decode_message(b"not json\n")
    with pytest.raises(TR.ProtocolError):
        TR.decode_message(json.dumps(
            {"protocol": TR.PROTOCOL_VERSION, "type": "nope", "body": {}}))
    with pytest.raises(TR.ProtocolError):
        TR.decode_message(json.dumps({"type": "error", "body": {}}))
    with pytest.raises(TR.ProtocolError, match="protocol-mismatch"):
        TR.decode_message(json.dumps({"protocol": 5, "type": "heartbeat",
                                      "body": {"job_name": "j", "lease": "x"}}))


# ---------------------------------------------------------------- snapshots


class TestSnapshotRoundTrip:
    """Snapshots across packages, with factors, and their refusals are
    ``tests/test_torch_service.py``'s; this is the case with live pending
    candidates."""

    def test_roundtrip_mid_fantasy_pending(self):
        """Snapshot taken with pending candidates: the restored engine
        fantasizes over the same pending set and stays bit-identical."""
        a = _service()
        h = a.register_job("job", _space(), bo_config=_CFG, seed=5)
        _drive(h, 5)
        for j, c in enumerate(h.suggest_batch(2)):
            h.store.mark_pending(f"p{j}", c)
        rh = _service().restore_job(json.loads(json.dumps(a.snapshot_job("job"))))
        assert rh.store.num_pending == 2
        assert h.suggest_batch(2) == rh.suggest_batch(2)


# ------------------------------------------------------------------- socket


class TestSocketEquivalence:
    def test_suggestion_stream_exact(self):
        ref = _drive(_service().register_job("job", _space(), bo_config=_CFG, seed=5), 8)
        with _server() as server:
            rh = RemoteService([server.address]).register_job(
                "job", _space(), bo_config=_CFG, seed=5)
            got = _drive(rh, 8)
            rh.close()
        assert got == ref
        _close(got, _reference_stream(8))

    def test_cross_package_pairs(self):
        """The port's client drives the reference's replica, and the
        reference's client drives the port's replica: each serves its own
        package's stream, and the two agree to 1e-9."""
        with JServer() as jserver:
            rh = RemoteService([jserver.address]).register_job(
                "job", _space(), bo_config=_CFG, seed=5)
            via_j = _drive(rh, 6)
            rh.close()
        with _server() as server:
            jrh = JRemote([server.address]).register_job(
                "job", _space(J), bo_config=_cfg("jax"), seed=5)
            via_t = _drive(jrh, 6)
            jrh.close()
        assert via_t == _drive(
            _service().register_job("job", _space(), bo_config=_CFG, seed=5), 6)
        assert via_j == _reference_stream(6)
        _close(via_t, via_j)

    def test_tuner_trial_table_exact(self):
        ref = _run_tuner(_service(default_bo_config=_CFG))
        with _server(service_config=T.ServiceConfig(default_bo_config=_CFG)) as server:
            got = _run_tuner(RemoteService([server.address]))
        assert _table(got) == _table(ref)
        _close_tables(got, _run_tuner(_service("jax", default_bo_config=_cfg("jax")),
                                      pkg="jax"))

    def test_replica_crash_failover_exact_no_retry_budget(self):
        """The serving replica dies mid-job (listener closed and the live
        connection cut): the handle re-adopts on the other replica from its
        last snapshot and the run ends with the same trial table; replica
        death costs no trial attempt."""
        ref = _run_tuner(_service(default_bo_config=_CFG))
        sc = T.ServiceConfig(default_bo_config=_CFG)
        s1, s2 = _server(service_config=sc).start(), _server(service_config=sc).start()
        killed = []

        def kill_after_third(tuner, trial):
            done = sum(1 for t in tuner.trials.values() if t.is_terminal)
            if done == 3 and not killed:
                s1.shutdown()
                conn = tuner._service_handle._conn
                if conn is not None:
                    conn.close()
                killed.append(True)

        try:
            got = _run_tuner(RemoteService([s1.address, s2.address], snapshot_every=4),
                             callbacks=[kill_after_third])
        finally:
            s2.shutdown()
        assert killed
        assert _table(got) == _table(ref)
        assert got.num_failed_attempts == ref.num_failed_attempts == 0
        assert all(t.attempts == 1 for t in got.trials)

    def test_tuner_checkpoint_kill_restore(self, tmp_path):
        ref = _run_tuner(_service(default_bo_config=_CFG))

        class _Crash(Exception):
            pass

        def boom(tuner, trial):
            if sum(1 for t in tuner.trials.values() if t.is_terminal) == 3:
                raise _Crash()

        path = str(tmp_path / "remote_tuner.json")
        with _server(service_config=T.ServiceConfig(default_bo_config=_CFG)) as server:
            rsvc = RemoteService([server.address])
            with pytest.raises(_Crash):
                _run_tuner(rsvc, callbacks=[boom], checkpoint_path=path)
            tuner = _make_tuner(rsvc, checkpoint_path=path)
            tuner.restore()
            got = tuner.run()
        assert _table(got) == _table(ref)

    def test_budget_ledger_survives_failover(self):
        """A cost-aware job with max_cost: the replica dies mid-spend; the
        client re-charges the restored replica from its log, so the table
        and all three ledgers (mirror, surviving replica, in-process run)
        agree."""
        cfg = _cfg(cost_aware=True, cost_cooling=1.5)

        def make(service, callbacks=()):
            def objective(c):
                return _obj(c) + 0.5 * np.exp(-0.4 * np.arange(1, 6)), 0.5 + c["x"]

            return T.Tuner(
                _space(), objective, None, TSim(startup_cost=2.0),
                T.TuningJobConfig(max_trials=8, max_parallel=2, job_name="job",
                                  seed=3, max_cost=500.0),
                service=service, callbacks=callbacks)

        ref_tuner = make(_service(default_bo_config=cfg))
        ref = ref_tuner.run()
        sc = T.ServiceConfig(default_bo_config=cfg)
        s1, s2 = _server(service_config=sc).start(), _server(service_config=sc).start()
        killed = []

        def kill_after_third(tuner, trial):
            if sum(1 for t in tuner.trials.values() if t.is_terminal) == 3 and not killed:
                assert tuner.budget_ledger.spent > 0.0
                s1.shutdown()
                conn = tuner._service_handle._conn
                if conn is not None:
                    conn.close()
                killed.append(True)

        try:
            tuner = make(RemoteService([s1.address, s2.address], snapshot_every=4),
                         callbacks=[kill_after_third])
            got = tuner.run()
            replica_led = s2.service.job("job").budget_ledger
        finally:
            s2.shutdown()
        assert killed and _table(got) == _table(ref)
        assert tuner.budget_ledger.spent == pytest.approx(replica_led.spent, abs=1e-9)
        assert tuner.budget_ledger.spent == pytest.approx(ref_tuner.budget_ledger.spent,
                                                          abs=1e-9)
        assert tuner.budget_ledger.max_cost == replica_led.max_cost == 500.0


def _make_tuner(service, callbacks=(), checkpoint_path=None, pkg="torch"):
    p = PKG[pkg]

    def objective(cfg):
        return _obj(cfg) + 0.5 * np.exp(-0.4 * np.arange(1, 6)), 1.0

    return p["C"].Tuner(
        _space(p["C"]), objective, None, p["Sim"](startup_cost=2.0),
        p["C"].TuningJobConfig(max_trials=8, max_parallel=2, job_name="job", seed=3,
                               checkpoint_path=checkpoint_path),
        service=service, callbacks=callbacks,
    )


def _run_tuner(service, callbacks=(), checkpoint_path=None, pkg="torch"):
    return _make_tuner(service, callbacks, checkpoint_path, pkg).run()


def _table(result):
    return [
        (t.trial_id, t.config, str(t.state), t.objective, t.attempts)
        for t in result.trials
    ]


def _close_tables(got, want):
    g, w = _table(got), _table(want)
    assert [(r[0], r[2], r[4]) for r in g] == [(r[0], r[2], r[4]) for r in w]
    _close([r[1] for r in g], [r[1] for r in w])
    np.testing.assert_allclose([r[3] for r in g], [r[3] for r in w], rtol=0, atol=TOL)


# ------------------------------------------------------------------- leases


class TestLeases:
    def _register(self, conn, name="job", **kw):
        reply = conn.call(TR.RegisterRequest(
            job_name=name, space_spec=_space().to_spec(), seed=5,
            bo_config=TR.bo_config_to_wire(_CFG), **kw,
        ))
        assert not isinstance(reply, TR.ErrorReply), reply
        return reply

    def test_expired_lease_refused_then_adoptable(self):
        clock = _FakeClock()
        with _server(lease_ttl=30.0, clock=clock) as server:
            conn = _Connection(server.address, 5.0, 60.0)
            lease = self._register(conn).lease
            conn2 = _Connection(server.address, 5.0, 60.0)
            reply = conn2.call(TR.RegisterRequest(
                job_name="job", space_spec=_space().to_spec(), seed=5,
                bo_config=TR.bo_config_to_wire(_CFG),
            ))
            assert isinstance(reply, TR.ErrorReply)
            assert reply.code == TR.ErrorCode.LEASE_HELD
            assert reply.retry_after == pytest.approx(30.0)
            clock.t += 31.0
            reply = conn.call(TR.SuggestBatchRequest(
                job_name="job", lease=lease, k=1, store_version=0, num_pending=0))
            assert isinstance(reply, TR.ErrorReply)
            assert reply.code == TR.ErrorCode.LEASE_EXPIRED
            self._register(conn2)  # now adoptable by the other client
            conn.close()
            conn2.close()

    def test_request_renews_lease(self):
        clock = _FakeClock()
        with _server(lease_ttl=30.0, clock=clock) as server:
            conn = _Connection(server.address, 5.0, 60.0)
            lease = self._register(conn).lease
            for _ in range(3):  # 3 × 20 s idle, renewed in between
                clock.t += 20.0
                reply = conn.call(TR.SuggestBatchRequest(
                    job_name="job", lease=lease, k=1, store_version=0, num_pending=0))
                assert not isinstance(reply, TR.ErrorReply), reply
            conn.close()

    def test_same_replica_readopt_with_stale_baseline(self):
        """Lease expiry on a replica that still hosts the job: the lease is
        granted on the resident state (fingerprint-verified), not on the
        stale snapshot baseline."""
        clock = _FakeClock()
        with _server(lease_ttl=30.0, clock=clock) as server:
            rh = RemoteService([server.address], snapshot_every=1000).register_job(
                "job", _space(), bo_config=_CFG, seed=5)
            first = _drive(rh, 6)
            clock.t += 31.0
            cont = _drive(rh, 3, start=6)
            rh.close()
        h = _service().register_job("job", _space(), bo_config=_CFG, seed=5)
        assert _drive(h, 6) == first
        assert _drive(h, 3, start=6) == cont

    def test_client_readopts_transparently_on_expiry(self):
        clock = _FakeClock()
        with _server(lease_ttl=30.0, clock=clock) as server:
            rh = RemoteService([server.address]).register_job(
                "job", _space(), bo_config=_CFG, seed=5)
            first = _drive(rh, 4)
            clock.t += 31.0
            cont = _drive(rh, 2, start=4)
            rh.close()
        h = _service().register_job("job", _space(), bo_config=_CFG, seed=5)
        assert _drive(h, 4) == first
        assert _drive(h, 2, start=4) == cont

    def test_auto_heartbeat_keeps_lease_alive_while_idle(self):
        with _server(lease_ttl=1.5) as server:
            rh = RemoteService([server.address]).register_job(
                "job", _space(), bo_config=_CFG, seed=5)
            first = _drive(rh, 2)
            time.sleep(3.5)  # > 2× TTL with no requests
            with server._lock:
                assert server._leases["job"].token == rh._lease
            cont = _drive(rh, 2, start=2)
            rh.close()
        h = _service().register_job("job", _space(), bo_config=_CFG, seed=5)
        assert _drive(h, 2) == first
        assert _drive(h, 2, start=2) == cont

    def test_lease_held_waits_out_dead_holder(self):
        with _server(lease_ttl=1.5) as server:
            ha = RemoteService([server.address]).register_job(
                "job", _space(), bo_config=_CFG, seed=5)
            _drive(ha, 2)
            ha.close()  # a crash: renewals stop, the lease lingers
            t0 = time.monotonic()
            hb = RemoteService([server.address]).register_job(
                "job", _space(), bo_config=_CFG, seed=5)
            assert time.monotonic() - t0 < 10.0
            assert hb.suggest_batch(1)
            hb.close()

    def test_lease_held_by_live_holder_refused(self):
        with _server(lease_ttl=1.5) as server:
            a = RemoteService([server.address]).register_job(
                "job", _space(), bo_config=_CFG, seed=5)
            with pytest.raises(TR.ProtocolError, match="lease-held"):
                RemoteService([server.address]).register_job(
                    "job", _space(), bo_config=_CFG, seed=5)
            a.close()

    def test_unknown_job_refused(self):
        with _server() as server:
            conn = _Connection(server.address, 5.0, 60.0)
            reply = conn.call(TR.SuggestBatchRequest(
                job_name="ghost", lease="x", k=1, store_version=0, num_pending=0))
            assert isinstance(reply, TR.ErrorReply)
            assert reply.code == TR.ErrorCode.UNKNOWN_JOB
            conn.close()

    def test_close_joins_heartbeat_and_never_releases(self):
        with _server(lease_ttl=1.0) as server:
            rh = RemoteService([server.address]).register_job(
                "job", _space(), bo_config=_CFG, seed=5)
            _drive(rh, 1)
            t = rh._heartbeat_thread
            assert t is not None and t.is_alive()
            with server._lock:
                token_before = server._leases["job"].token
            rh.close()
            assert not t.is_alive() and rh._closed
            with pytest.raises(RemoteServiceError, match="closed"):
                rh.heartbeat()
            with pytest.raises(RemoteServiceError, match="closed"):
                rh.suggest_batch(1)
            with server._lock:
                assert server._leases["job"].token == token_before
            rh._start_heartbeats()
            assert rh._heartbeat_thread is t  # no fresh renewer after close


# ---------------------------------------------------------------- refusals


class TestProtocolRefusals:
    def test_protocol_version_mismatch(self):
        with _server() as server:
            conn = _Connection(server.address, 5.0, 60.0)
            raw = json.dumps({
                "protocol": TR.PROTOCOL_VERSION + 1, "type": "heartbeat",
                "body": {"job_name": "j", "lease": "x"},
            }) + "\n"
            conn._sock.sendall(raw.encode())
            reply = TR.decode_message(conn._rfile.readline())
            assert isinstance(reply, TR.ErrorReply)
            assert reply.code == TR.ErrorCode.PROTOCOL_MISMATCH
            conn.close()

    def test_snapshot_version_mismatch_over_wire(self):
        svc = _service()
        svc.register_job("job", _space(), bo_config=_CFG, seed=5)
        snap = svc.snapshot_job("job")
        snap["snapshot_version"] = 999
        with _server() as server:
            conn = _Connection(server.address, 5.0, 60.0)
            reply = conn.call(TR.RegisterRequest(job_name="job", snapshot=snap))
            assert isinstance(reply, TR.ErrorReply)
            assert reply.code == TR.ErrorCode.SNAPSHOT_MISMATCH
            conn.close()

    def test_stale_store_refused(self):
        with _server() as server:
            conn = _Connection(server.address, 5.0, 60.0)
            reply = conn.call(TR.RegisterRequest(
                job_name="job", space_spec=_space().to_spec(), seed=5,
                bo_config=TR.bo_config_to_wire(_CFG)))
            stale = conn.call(TR.SuggestBatchRequest(
                job_name="job", lease=reply.lease, k=1, store_version=7,
                num_pending=0))
            assert isinstance(stale, TR.ErrorReply)
            assert stale.code == TR.ErrorCode.STALE_STATE
            conn.close()

    def test_engine_state_rpc_matches_in_process(self):
        """The per-event checkpoint blob travels as its own RPC and equals
        the in-process engine's state exactly."""
        h = _service().register_job("job", _space(), bo_config=_CFG, seed=5)
        _drive(h, 5)
        with _server() as server:
            rh = RemoteService([server.address]).register_job(
                "job", _space(), bo_config=_CFG, seed=5)
            _drive(rh, 5)
            remote_state = rh.suggester.state_dict()
            rh.close()
        assert json.loads(json.dumps(remote_state)) == json.loads(
            json.dumps(h.suggester.state_dict()))

    def test_stale_handle_raises(self):
        with _server() as server:
            rsvc = RemoteService([server.address])
            h1 = rsvc.register_job("job", _space(), bo_config=_CFG, seed=5)
            h2 = rsvc.register_job("job", _space(), bo_config=_CFG, seed=5)
            assert h1.stale
            with pytest.raises(RuntimeError, match="stale"):
                h1.suggest_batch(1)
            h2.close()

    def test_replayed_divergence_is_loud(self):
        """A replayed suggestion that differs from what was handed out
        raises instead of continuing the stream."""
        with _server() as server:
            rh = RemoteService([server.address], snapshot_every=1000).register_job(
                "job", _space(), bo_config=_CFG, seed=5)
            _drive(rh, 2)
            op = rh._oplog[0]
            assert op[0] == "suggest"
            rh._oplog[0] = op[:4] + ([{"x": 0.5, "y": 0.5}],)
            # the replica loses the job: re-adoption restores the baseline
            # snapshot taken at registration and replays the log
            with server._lock:
                server.service._jobs.pop("job")
                server._leases.pop("job")
            rh._lease = None
            with pytest.raises(ReplicaDivergenceError):
                rh.heartbeat()
            rh.close()


# ------------------------------------------------- telemetry over the wire


class TestTelemetryWire:
    @pytest.fixture(autouse=True)
    def _quiet(self):
        telemetry.set_enabled(False)
        telemetry.get().reset()
        yield
        telemetry.set_enabled(False)
        telemetry.get().reset()

    def test_streams_bit_identical_over_socket(self):
        """Socket-served suggestions with telemetry on at every hop equal the
        quiet in-process stream byte for byte."""
        ref = _drive(_service().register_job("job", _space(), bo_config=_CFG, seed=5), 8)
        telemetry.set_enabled(True)
        with _server() as server:
            rh = RemoteService([server.address]).register_job(
                "job", _space(), bo_config=_CFG, seed=5)
            got = _drive(rh, 8)
            rh.close()
        assert got == ref
        m = telemetry.get().metrics()
        assert m["counters"]["server.rpc.suggest_batch"] == 8
        assert m["histograms"]["span.rpc.suggest_batch"]["count"] == 8

    def test_metrics_rpc_verb_live_replica(self):
        telemetry.set_enabled(True)
        with _server() as server:
            rsvc = RemoteService([server.address])
            rh = rsvc.register_job("job", _space(), bo_config=_CFG, seed=1)
            _drive(rh, 4)
            dump = rsvc.fetch_metrics()
            rh.close()
        counters = dump["metrics"]["counters"]
        assert counters["server.rpc.suggest_batch"] == 4
        assert counters["server.rpc.register"] == 1
        hist = dump["metrics"]["histograms"]
        assert hist["span.rpc.suggest_batch"]["count"] == 4
        assert hist["span.service.suggest_batch"]["count"] == 4
        assert dump["service_stats"]["groups"][0]["jobs"] == ["job"]

    def test_metrics_verb_on_reference_replica_from_port_client(self):
        """The read-only verb crosses packages: the port's client reads a
        reference replica's registry."""
        jtelemetry.set_enabled(False)
        with JServer() as jserver:
            dump = RemoteService([jserver.address]).fetch_metrics()
        assert dump["metrics"]["enabled"] is False
        assert dump["service_stats"]["groups"] == []

    def test_no_telemetry_keys_in_wire_snapshot(self):
        telemetry.set_enabled(True)
        with _server() as server:
            rh = RemoteService([server.address]).register_job(
                "job", _space(), bo_config=_CFG, seed=9)
            _drive(rh, 5)
            snap = rh.fetch_snapshot(include_factors=True)
            rh.close()
        image = json.dumps(snap, sort_keys=True).lower()
        for token in ("telemetry", '"span', '"trace', "span_id"):
            assert token not in image
