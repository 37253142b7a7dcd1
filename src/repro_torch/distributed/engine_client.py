"""Client side of the cross-process SelectionService: replica leasing,
snapshot-based failover, and a ``Tuner``-compatible ``RemoteService``.

``RemoteService`` is a drop-in for ``SelectionService`` in
``Tuner(..., service=...)``: ``register_job`` returns a ``RemoteJobHandle``
with the same surface as the in-process ``JobHandle`` (``suggest_batch``,
``store``, ``suggester``, ``warm_pool``), but decisions are served by an
``EngineServer`` replica over the wire protocol of ``repro_torch.core.rpc``
(the JAX package's messages and bytes: this client also drives a replica of
the JAX package, and its replicas serve the JAX package's client).

How the bit-equivalence contract survives replica failure: the engine is
deterministic, so a job's state is fully captured by (last engine snapshot,
ordered log of requests since). The handle keeps exactly that —

  * after registration and every ``snapshot_every`` state-mutating requests
    it publishes a fresh snapshot (``SelectionService.snapshot_job`` fetched
    over the wire) and truncates the log;
  * when a replica dies (dead socket) or refuses (``lease-expired``), the
    handle re-registers — on the same replica or the next one in the fleet —
    with ``RegisterRequest(snapshot=...)``. A replica that still hosts the
    live job grants the lease on its *resident* state (verified byte-exactly
    against the client mirror via the store fingerprint — no replay needed);
    otherwise the snapshot is restored and the handle *replays* the logged
    requests in order. Replayed suggestions must come back identical to what
    the dead replica served (they were already handed to the caller); the
    client verifies this and raises ``ReplicaDivergenceError`` on any
    mismatch rather than continuing silently.

A background renewer heartbeats each live handle at ~TTL/3 so leases
survive long idle gaps (trials slower than the TTL produce no RPC traffic).

The local ``MirroredStore`` keeps a synchronous replica of the job's
observation store, so the Tuner's checkpointing, introspection, and
store-version handshakes (``SuggestBatchRequest.store_version``) all work
without extra round trips.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import telemetry
from repro_torch.core.history import ObservationStore
from repro_torch.core.rpc import (
    EngineRestoreRequest,
    EngineStateRequest,
    ErrorCode,
    ErrorReply,
    HeartbeatRequest,
    Message,
    ObserveRequest,
    PromotionRequest,
    ProtocolError,
    RegisterRequest,
    ReportRungRequest,
    SnapshotRequest,
    SuggestBatchRequest,
    bo_config_to_wire,
    decode_message,
    encode_message,
)
from repro_torch.core.search_space import SearchSpace
from repro_torch.core.suggest import BOConfig
from repro_torch.core.warm_start import WarmStartPool

__all__ = [
    "MirroredStore",
    "RemoteJobHandle",
    "RemoteService",
    "RemoteServiceError",
    "RemoteSuggester",
    "ReplicaDivergenceError",
]

_LOG = logging.getLogger(__name__)


class RemoteServiceError(RuntimeError):
    """No replica in the fleet could serve the request."""


class ReplicaDivergenceError(RemoteServiceError):
    """A replica's view of the job disagrees with the client's — e.g. a
    replayed suggestion came back different from what was already handed to
    the caller. This is the loud failure the wire protocol's version checks
    exist to force; continuing would corrupt the suggestion stream."""


class _Connection:
    """One persistent newline-framed JSON connection to a replica."""

    def __init__(self, address: Tuple[str, int], connect_timeout: float,
                 call_timeout: float):
        self.address = tuple(address)
        self._sock = socket.create_connection(self.address, timeout=connect_timeout)
        self._sock.settimeout(call_timeout)
        self._rfile = self._sock.makefile("rb")

    def call(self, msg: Message) -> Message:
        """One request/reply round trip. Raises OSError/EOFError on a dead
        socket (the failover trigger), ProtocolError on undecodable bytes."""
        self._sock.sendall(encode_message(msg))
        line = self._rfile.readline()
        if not line:
            raise EOFError(f"replica {self.address} closed the connection")
        return decode_message(line)

    def close(self) -> None:
        try:
            self._rfile.close()
            self._sock.close()
        except OSError:
            pass


class MirroredStore(ObservationStore):
    """An ``ObservationStore`` that synchronously mirrors every transition to
    the job's replica (push / mark_pending / clear_pending), keeping the
    local and remote stores in lock-step. The local copy serves reads
    (standardization never happens client-side in remote mode, but Tuner
    checkpointing and the store-version handshake do)."""

    def __init__(self, space: SearchSpace, handle: "RemoteJobHandle",
                 warm_start=None, metrics=None):
        self._handle: Optional[RemoteJobHandle] = None  # silence during init
        super().__init__(space, warm_start=warm_start, metrics=metrics)
        self._handle = handle

    def push_encoded(self, x: np.ndarray, y: float, key=None, cost=None) -> bool:
        accepted = super().push_encoded(x, y, key=key, cost=cost)
        if accepted and self._handle is not None:
            self._handle._observe_push(np.asarray(x), float(y),
                                       expect_version=self.num_observations,
                                       key=key, cost=cost)
        return accepted

    def push_vector_encoded(self, x: np.ndarray, yvec: np.ndarray, key=None) -> bool:
        if self.num_metrics == 1:
            # delegates to ``push_encoded`` above — mirrored there.
            return super().push_vector_encoded(x, yvec, key=key)
        accepted = ObservationStore.push_vector_encoded(self, x, yvec, key=key)
        if accepted and self._handle is not None:
            self._handle._observe_push_vector(
                np.asarray(x), np.asarray(yvec, dtype=np.float64),
                expect_version=self.num_observations, key=key,
            )
        return accepted

    def mark_pending(self, key, config: Mapping[str, Any]) -> None:
        super().mark_pending(key, config)
        if self._handle is not None:
            self._handle._observe_pending(key, dict(config))

    def clear_pending(self, key) -> None:
        super().clear_pending(key)
        if self._handle is not None:
            self._handle._observe_clear(key)


class RemoteSuggester:
    """The ``Tuner``-facing suggester shim of a remote job: decisions and
    checkpoint state both round-trip to the replica (``state_dict`` returns
    the replica engine's ``BOSuggester.state_dict``; ``load_state_dict``
    installs one), so tuner checkpoints taken in remote mode restore exactly
    like in-process ones."""

    def __init__(self, handle: "RemoteJobHandle"):
        self._handle = handle

    def suggest_batch(self, k: int) -> List[Dict[str, Any]]:
        return self._handle.suggest_batch(k)

    def state_dict(self) -> Dict[str, Any]:
        reply = self._handle._rpc(
            lambda lease: EngineStateRequest(
                job_name=self._handle.name, lease=lease
            )
        )
        return dict(reply.state)

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        self._handle._engine_restore(dict(state))


class RemoteJobHandle:
    """A tuning job leased onto an engine-replica fleet.

    Same decision surface as the in-process ``JobHandle``; additionally owns
    the failover machinery (snapshot + request log + replica round-robin).
    Obtain via ``RemoteService.register_job`` — the constructor does not
    touch the network; ``_establish`` (called by the service) does.
    """

    def __init__(
        self,
        service: "RemoteService",
        name: str,
        space: SearchSpace,
        bo_config: Optional[BOConfig],
        seed: int,
        warm_start: Optional[WarmStartPool],
        fold_siblings: bool,
        metrics=None,
        multi_fidelity=None,
        max_cost=None,
    ):
        self.name = name
        self.space = space
        self.service = service
        self.metrics = metrics  # Optional[MetricSet] (multi-metric jobs)
        # ASHA config wire dict (or None) — the replica owns the live state.
        self.multi_fidelity = multi_fidelity
        self.max_cost = max_cost
        # client-side mirror of the replica's budget ledger (same reason the
        # store is mirrored: the Tuner reads spend synchronously, and the
        # failover replay re-charges the replica from the oplog).
        self.budget_ledger = None
        cost_aware = bool(getattr(bo_config, "cost_aware", False))
        if max_cost is not None or cost_aware:
            from repro_torch.core.budget import BudgetLedger

            self.budget_ledger = BudgetLedger(max_cost)
        self.stale = False
        self.warm_pool: Optional[WarmStartPool] = None
        self.store: Optional[MirroredStore] = None
        self.suggester = RemoteSuggester(self)
        self._bo_config = bo_config
        self._seed = seed
        self._user_warm_start = warm_start
        self._fold_siblings = fold_siblings
        self._replica_idx = 0
        self._conn: Optional[_Connection] = None
        self._lease: Optional[str] = None
        self._lease_ttl: float = 0.0
        self._snapshot: Optional[Dict[str, Any]] = None
        self._oplog: List[Tuple[Any, ...]] = []
        self._takeover: Optional[str] = None  # set when re-registering a name
        # one connection, many callers (the tuning loop + the heartbeat
        # renewer): frame pairing on the socket is only safe serialized.
        self._io_lock = threading.RLock()
        self._stop_heartbeat = threading.Event()
        self._heartbeat_thread: Optional[threading.Thread] = None
        self._closed = False

    # ----------------------------------------------------------- public api
    def suggest_batch(self, k: int) -> List[Dict[str, Any]]:
        """Serve ``k`` candidates from the leased replica (identical to what
        the in-process engine would suggest). Raises ``RuntimeError`` on a
        stale handle, ``RemoteServiceError`` if no replica is reachable."""
        if self.stale:
            raise RuntimeError(
                f"RemoteJobHandle {self.name!r} is stale: the name was "
                "re-registered (give concurrent jobs distinct job names)"
            )
        if self.budget_ledger is not None:
            # mirror-side refusal, same type the in-process handle raises;
            # the replica enforces it independently (``budget-exhausted``).
            self.budget_ledger.check(self.name)
        sv, npend = self.store.num_observations, self.store.num_pending
        try:
            reply = self._rpc(
                lambda lease: SuggestBatchRequest(
                    job_name=self.name, lease=lease, k=k,
                    store_version=sv, num_pending=npend,
                )
            )
        except ProtocolError as e:
            if e.code == ErrorCode.BUDGET_EXHAUSTED:
                from repro_torch.core.budget import BudgetExhaustedError

                raise BudgetExhaustedError(e.message) from e
            raise
        configs = [dict(c) for c in reply.configs]
        self._log(("suggest", k, sv, npend, configs))
        return configs

    def observe_charge(self, cost: float) -> float:
        """Charge a terminal trial's cost against the budget: the mirror
        ledger synchronously, the replica's via a ``"charge"`` observe (the
        only wire path that spends budget). Logged, so failover replays the
        spend onto a snapshot-restored replica."""
        if self.budget_ledger is None:
            return 0.0
        spent = self.budget_ledger.charge(cost)
        self._rpc(
            lambda lease: ObserveRequest(
                job_name=self.name, lease=lease, kind="charge",
                cost=float(cost),
            )
        )
        self._log(("charge", float(cost)))
        return spent

    def observe(self, config: Mapping[str, Any], y: float) -> bool:
        """Record a finished observation (direct-drive API; the Tuner pushes
        through ``store`` instead). Mirrors to the replica via the store."""
        return self.store.push(config, y)

    def report_rung(self, key, iteration: int, value: float) -> str:
        """Report a running trial's rung crossing to the leased replica and
        return its in-service ASHA decision (``"stop"``/``"continue"``). The
        decision is logged with the op: on failover the replay re-issues the
        report and the restored replica must return the *memoized* original
        decision — verified, not assumed."""
        if self.stale:
            raise RuntimeError(
                f"RemoteJobHandle {self.name!r} is stale: the name was "
                "re-registered (give concurrent jobs distinct job names)"
            )
        reply = self._rpc(
            lambda lease: ReportRungRequest(
                job_name=self.name, lease=lease, key=key,
                iteration=int(iteration), value=float(value),
            )
        )
        decision = str(reply.decision)
        self._log(("rung", key, int(iteration), float(value), decision))
        return decision

    def promotion(self) -> Optional[Dict[str, Any]]:
        """Fetch the job's rung tables + memoized decisions from the replica
        (None for jobs without multi-fidelity)."""
        reply = self._rpc(
            lambda lease: PromotionRequest(job_name=self.name, lease=lease)
        )
        return reply.state

    def heartbeat(self) -> float:
        """Renew the lease without doing work; returns the TTL granted.
        A background renewer calls this automatically at ~TTL/3 while the
        handle is live, so leases survive trials longer than the TTL with no
        RPC traffic; it is also callable directly."""
        reply = self._rpc(
            lambda lease: HeartbeatRequest(job_name=self.name, lease=lease)
        )
        return float(reply.lease_ttl)

    def close(self) -> None:
        """Stop the heartbeat renewer and close the connection. The replica
        keeps the job; the lease simply runs out (making it adoptable).

        Joins the renewer thread (bounded) *before* taking the lock, so a
        renewal already in flight drains rather than deadlocking against
        us; the ``_closed`` flag then keeps any renewal that slipped past
        the stop event from re-adopting (re-leasing) a closed handle."""
        self._stop_heartbeat.set()
        t = self._heartbeat_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
        with self._io_lock:
            self._closed = True
            if self._conn is not None:
                self._conn.close()
                self._conn = None
            self._lease = None

    # ------------------------------------------------------ lease renewal
    def _start_heartbeats(self) -> None:
        with self._io_lock:
            if self._heartbeat_thread is not None or self._closed:
                return
            self._heartbeat_thread = threading.Thread(
                target=self._heartbeat_loop,
                name=f"lease-renew-{self.name}",
                daemon=True,
            )
            self._heartbeat_thread.start()

    def _heartbeat_loop(self) -> None:
        while True:
            interval = self._lease_ttl / 3.0 if self._lease_ttl > 0 else 10.0
            if self._stop_heartbeat.wait(max(0.5, interval)):
                return
            if self.stale or self._closed:
                return
            self._renew_once()

    def _renew_once(self) -> None:
        """One background lease renewal. The renewer must never crash the
        client — the next real request owns recovery/failover — but a failed
        renewal must never vanish either: it is counted and logged so a
        flapping fleet shows up in telemetry before it shows up as a stall."""
        try:
            self.heartbeat()
        except Exception as e:  # noqa: BLE001 — see docstring
            telemetry.count("client.heartbeat_error")
            _LOG.warning(
                "job %r: background lease renewal failed (%s: %s); "
                "next request will re-adopt",
                self.name, type(e).__name__, e,
            )

    def fetch_snapshot(self, include_factors: bool = False) -> Dict[str, Any]:
        """Fetch the replica's current engine snapshot for this job (also
        refreshes the handle's failover baseline). Advertises the frame
        codecs this process decodes; the server compresses with the best
        common one (or ships plain JSON — see ``repro_torch.core.rpc``). When the
        service sets ``snapshot_frame_bytes``, the compressed stream arrives
        chunked (``SnapshotReply.frames``) so large-n store images never
        become one message-sized wire string."""
        from repro_torch.core.rpc import (
            available_snapshot_codecs,
            decode_snapshot_frame,
            decode_snapshot_frames,
        )

        # hold the (re-entrant) lock across fetch *and* baseline publish:
        # the new snapshot must supersede exactly the ops logged before it.
        with self._io_lock:
            reply = self._rpc(
                lambda lease: SnapshotRequest(
                    job_name=self.name, lease=lease,
                    include_factors=include_factors,
                    accept_codecs=available_snapshot_codecs(),
                    max_frame_bytes=self.service.snapshot_frame_bytes,
                )
            )
            if reply.frames is not None:
                snap = decode_snapshot_frames(reply.frames, reply.codec)
            elif reply.codec is not None:
                snap = decode_snapshot_frame(
                    reply.snapshot["frame"], reply.codec
                )
            else:
                snap = reply.snapshot
            if not include_factors:
                self._snapshot = snap
                self._oplog = []
            return snap

    # -------------------------------------------------------- store mirrors
    def _observe_push(self, x: np.ndarray, y: float, expect_version: int,
                      key=None, cost=None) -> None:
        from repro_torch.core.gp.serialize import array_to_wire

        wire = array_to_wire(x)
        reply = self._rpc(
            lambda lease: ObserveRequest(
                job_name=self.name, lease=lease, kind="push", x=wire, y=y,
                key=key, cost=cost,
            )
        )
        if not reply.accepted or reply.store_version != expect_version:
            raise ReplicaDivergenceError(
                f"replica store at {reply.store_version} obs after push, "
                f"client mirror at {expect_version}"
            )
        self._log(("push", wire, y, key, cost))

    def _observe_push_vector(
        self, x: np.ndarray, yvec: np.ndarray, expect_version: int, key=None
    ) -> None:
        from repro_torch.core.gp.serialize import array_to_wire

        wire = array_to_wire(x)
        wire_ys = array_to_wire(yvec)
        reply = self._rpc(
            lambda lease: ObserveRequest(
                job_name=self.name, lease=lease, kind="push", x=wire,
                ys=wire_ys, key=key,
            )
        )
        if not reply.accepted or reply.store_version != expect_version:
            raise ReplicaDivergenceError(
                f"replica store at {reply.store_version} obs after push, "
                f"client mirror at {expect_version}"
            )
        self._log(("pushv", wire, wire_ys, key))

    def _observe_pending(self, key, config: Dict[str, Any]) -> None:
        self._rpc(
            lambda lease: ObserveRequest(
                job_name=self.name, lease=lease, kind="pending",
                key=key, config=config,
            )
        )
        self._log(("pending", key, config))

    def _observe_clear(self, key) -> None:
        self._rpc(
            lambda lease: ObserveRequest(
                job_name=self.name, lease=lease, kind="clear", key=key
            )
        )
        self._log(("clear", key))

    def _engine_restore(self, state: Dict[str, Any]) -> None:
        self._rpc(
            lambda lease: EngineRestoreRequest(
                job_name=self.name, lease=lease, suggester_state=state
            )
        )
        self._log(("engine_restore", state))

    # ------------------------------------------------------ failover engine
    def _rpc(self, make: Callable[[str], Message]) -> Message:
        """Send one request, transparently re-adopting the job on lease
        expiry or replica death. Refusals other than ``lease-expired``
        surface as ``ProtocolError`` — they mean the fleet disagrees with
        this client about the job, which must never be papered over."""
        last: Optional[BaseException] = None
        with self._io_lock:
            for _ in range(2 * max(1, len(self.service.addresses))):
                if self._closed:
                    # a renewal that slipped past close() must not
                    # re-register the job and leave a fresh lease behind
                    raise RemoteServiceError(
                        f"job {self.name!r}: handle is closed"
                    )
                try:
                    if self._conn is None or self._lease is None:
                        self._readopt()
                    reply = self._conn.call(make(self._lease))
                except (OSError, EOFError) as e:
                    last = e
                    telemetry.count("client.failover")
                    self._drop_replica_locked()
                    continue
                if isinstance(reply, ErrorReply):
                    if reply.code == ErrorCode.LEASE_EXPIRED:
                        telemetry.count("client.lease_expired")
                        self._lease = None  # re-adopt (same replica first)
                        continue
                    raise ProtocolError(reply.code, reply.message)
                return reply
        raise RemoteServiceError(
            f"job {self.name!r}: no replica reachable ({last})"
        )

    def _log(self, op: Tuple[Any, ...]) -> None:
        # the heartbeat renewer can trigger a re-adopt (which replays and
        # truncates the oplog) concurrently with the tuning loop logging —
        # the baseline and the log must only move together, under the lock.
        with self._io_lock:
            self._oplog.append(op)
            if len(self._oplog) >= self.service.snapshot_every:
                self.fetch_snapshot()  # refreshes baseline, truncates the log

    def _drop_replica_locked(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None
        self._lease = None
        self._replica_idx = (self._replica_idx + 1) % len(self.service.addresses)

    def _register_message(self) -> RegisterRequest:
        from repro_torch.core.rpc import available_snapshot_codecs

        caps = [f"snapshot-{c}" for c in available_snapshot_codecs()]
        if self._snapshot is not None:
            return RegisterRequest(
                job_name=self.name, snapshot=self._snapshot,
                takeover_lease=self._takeover, capabilities=caps,
            )
        return RegisterRequest(
            job_name=self.name,
            space_spec=self.space.to_spec(),
            seed=self._seed,
            bo_config=None
            if self._bo_config is None
            else bo_config_to_wire(self._bo_config),
            warm_start_state=None
            if self._user_warm_start is None
            else self._user_warm_start.state_dict(),
            fold_siblings=self._fold_siblings,
            takeover_lease=self._takeover,
            metric_specs=None
            if self.metrics is None
            else self.metrics.to_wire(),
            multi_fidelity=self.multi_fidelity,
            max_cost=self.max_cost,
            capabilities=caps,
        )

    def _readopt(self) -> None:
        """(Re-)establish a session: connect, register (fresh, from the last
        snapshot, or onto resident replica state), replay the logged requests
        since the snapshot when the replica actually restored it, and publish
        a new baseline. Tries every replica once, round-robin."""
        with self._io_lock:
            self._readopt_locked()

    def _readopt_locked(self) -> None:
        deadline: Optional[float] = None
        while True:
            held_wait = self._readopt_round_locked()
            if held_wait is None:
                return
            # every reachable replica refused with lease-held: another
            # client's lease is live. If that client crashed, the job
            # becomes adoptable exactly when the lease runs out — wait it
            # out (plus grace), re-trying; a *live* holder keeps renewing,
            # so the deadline passes and the refusal surfaces.
            now = time.monotonic()
            if deadline is None:
                deadline = now + held_wait + 2.0
            if now >= deadline:
                raise ProtocolError(
                    ErrorCode.LEASE_HELD,
                    f"job {self.name!r} is still leased by a live client "
                    "after waiting out the reported TTL",
                )
            time.sleep(min(1.0, max(0.05, deadline - now)))

    def _readopt_round_locked(self) -> Optional[float]:
        """Try every replica once. Returns None on success; the longest
        reported lease-held ``retry_after`` if adoption should be retried
        after waiting; raises on terminal failure."""
        last: Optional[BaseException] = None
        held_wait: Optional[float] = None
        for _ in range(max(1, len(self.service.addresses))):
            address = self.service.addresses[self._replica_idx]
            conn = None
            try:
                conn = _Connection(
                    address, self.service.connect_timeout, self.service.call_timeout
                )
                reply = conn.call(self._register_message())
                if isinstance(reply, ErrorReply):
                    conn.close()
                    if reply.code == ErrorCode.STALE_DRAWS:
                        # this replica holds conflicting pool draws for our
                        # space group — it is the wrong host, not an error
                        last = ProtocolError(reply.code, reply.message)
                        self._replica_idx = (
                            self._replica_idx + 1
                        ) % len(self.service.addresses)
                        continue
                    if reply.code == ErrorCode.LEASE_HELD:
                        held_wait = max(
                            held_wait or 0.0, reply.retry_after or 1.0
                        )
                        self._replica_idx = (
                            self._replica_idx + 1
                        ) % len(self.service.addresses)
                        continue
                    raise ProtocolError(reply.code, reply.message)
                if self._conn is not None:
                    self._conn.close()
                self._conn = conn
                self._lease = reply.lease
                self._lease_ttl = float(reply.lease_ttl)
                self._takeover = None
                self._after_register(reply)
                telemetry.count("client.readopt")
                if reply.adopted_resident:
                    # the replica still hosts the live job (lease had merely
                    # lapsed): its state is snapshot+oplog already applied —
                    # verified byte-exactly below — so nothing to replay.
                    self._verify_resident(reply)
                else:
                    self._replay()
                    if self._oplog or self._snapshot is None:
                        # publish a baseline immediately: every *re*-adoption
                        # must travel the snapshot path. A fresh register
                        # onto a replica whose group pool retains published
                        # draws builds an engine that would adopt them at its
                        # first refit cadence — a legitimate sibling-joining
                        # engine, but not the one whose stream we continue.
                        self.fetch_snapshot()
                return None
            except (OSError, EOFError) as e:
                if conn is not None:
                    conn.close()
                last = e
                telemetry.count("client.readopt_error")
                _LOG.warning(
                    "job %r: readopt attempt on %s failed (%s: %s)",
                    self.name, address, type(e).__name__, e,
                )
                self._replica_idx = (
                    self._replica_idx + 1
                ) % len(self.service.addresses)
        if held_wait is not None:
            return held_wait
        raise RemoteServiceError(
            f"job {self.name!r}: no replica would adopt ({last})"
        )

    def _verify_resident(self, reply) -> None:
        """A lease granted on resident replica state is only trustworthy if
        that state *is* the one this client has been mirroring — checked
        byte-exactly via the store fingerprint, never assumed."""
        if self.store is None:
            return  # first registration: the mirror is built from the reply
        if (
            reply.store_version != self.store.num_observations
            or reply.num_pending != self.store.num_pending
            or reply.store_fingerprint != self.store.fingerprint()
        ):
            raise ReplicaDivergenceError(
                f"job {self.name!r}: resident replica store "
                f"({reply.store_version} obs, {reply.num_pending} pending, "
                f"fingerprint {reply.store_fingerprint}) does not match the "
                f"client mirror ({self.store.num_observations} obs, "
                f"{self.store.num_pending} pending)"
            )

    def _after_register(self, reply) -> None:
        """First registration builds the local mirror (warm pool + store)
        from the reply; re-registrations only sanity-check the parent count
        (a mismatch means the replica folded different sibling data than the
        engine whose stream we are continuing)."""
        if self.store is None:
            pool = None
            if reply.warm_pool_state:
                pool = WarmStartPool()
                pool.load_state_dict(reply.warm_pool_state)
            self.warm_pool = pool
            self.store = MirroredStore(
                self.space, self, warm_start=pool, metrics=self.metrics
            )
        if reply.num_parents != self.store.num_parents:
            raise ReplicaDivergenceError(
                f"replica folded {reply.num_parents} parent rows, client "
                f"mirror has {self.store.num_parents}"
            )

    def _replay(self) -> None:
        """Re-apply the logged requests on a freshly adopted replica. The
        engine is deterministic, so replayed suggestions must reproduce the
        exact configs already handed to the caller — verified, not assumed."""
        if self._oplog:
            telemetry.count("client.oplog.replayed_ops", len(self._oplog))
            telemetry.observe("client.oplog.replay_len", len(self._oplog))
        for op in self._oplog:
            kind = op[0]
            if kind == "suggest":
                _, k, sv, npend, configs = op
                reply = self._conn.call(
                    SuggestBatchRequest(
                        job_name=self.name, lease=self._lease, k=k,
                        store_version=sv, num_pending=npend,
                    )
                )
                self._check_replay(reply)
                if [dict(c) for c in reply.configs] != configs:
                    raise ReplicaDivergenceError(
                        f"job {self.name!r}: replayed suggest_batch({k}) "
                        "diverged from the original suggestions"
                    )
            elif kind == "push":
                _, wire, y, key, cost = op
                reply = self._conn.call(
                    ObserveRequest(job_name=self.name, lease=self._lease,
                                   kind="push", x=wire, y=y, key=key,
                                   cost=cost)
                )
                self._check_replay(reply)
            elif kind == "charge":
                reply = self._conn.call(
                    ObserveRequest(job_name=self.name, lease=self._lease,
                                   kind="charge", cost=op[1])
                )
                self._check_replay(reply)
            elif kind == "pushv":
                _, wire, wire_ys, key = op
                reply = self._conn.call(
                    ObserveRequest(job_name=self.name, lease=self._lease,
                                   kind="push", x=wire, ys=wire_ys, key=key)
                )
                self._check_replay(reply)
            elif kind == "rung":
                _, key, iteration, value, decision = op
                reply = self._conn.call(
                    ReportRungRequest(job_name=self.name, lease=self._lease,
                                      key=key, iteration=iteration,
                                      value=value)
                )
                self._check_replay(reply)
                if reply.decision != decision:
                    # the restored replica must hand back the memoized
                    # original decision; anything else means the trial was
                    # (or was not) stopped on state we cannot reproduce.
                    raise ReplicaDivergenceError(
                        f"job {self.name!r}: replayed report_rung({key!r}, "
                        f"iter {iteration}) decided {reply.decision!r}, "
                        f"original decision was {decision!r}"
                    )
            elif kind == "pending":
                _, key, config = op
                reply = self._conn.call(
                    ObserveRequest(job_name=self.name, lease=self._lease,
                                   kind="pending", key=key, config=config)
                )
                self._check_replay(reply)
            elif kind == "clear":
                _, key = op
                reply = self._conn.call(
                    ObserveRequest(job_name=self.name, lease=self._lease,
                                   kind="clear", key=key)
                )
                self._check_replay(reply)
            elif kind == "engine_restore":
                reply = self._conn.call(
                    EngineRestoreRequest(job_name=self.name, lease=self._lease,
                                         suggester_state=op[1])
                )
                self._check_replay(reply)

    @staticmethod
    def _check_replay(reply: Message) -> None:
        if isinstance(reply, ErrorReply):
            raise ProtocolError(reply.code, reply.message)


class RemoteService:
    """``SelectionService`` drop-in whose engines live in other processes.

    Args:
        addresses: ``(host, port)`` tuples of the engine-replica fleet
            (``EngineServer`` instances). A job is leased to one replica at a
            time; on replica death or lease expiry the handle re-adopts onto
            the next replica from its last published snapshot.
        bo_config: default engine config for registered jobs (the remote
            analogue of ``ServiceConfig.default_bo_config``; the replica's
            own default applies when None).
        snapshot_every: state-mutating requests between snapshot refreshes —
            the failover replay log never grows past this.
        snapshot_frame_bytes: when set, snapshot fetches ask the replica for
            the *chunked* reply shape — compressed bytes split into pieces
            of at most this size — so large-n store images stream in bounded
            frames (None keeps the single-frame v2 shape).
        connect_timeout/call_timeout: socket timeouts in seconds; a timeout
            counts as replica death and triggers failover.

    Use exactly like the in-process service::

        svc = RemoteService([server.address])
        Tuner(space, objective, None, backend, job_config, service=svc)

    Constraints vs in-process mode: the suggester must be service-created
    (``suggester=None`` — code cannot be shipped), and config values must be
    JSON-safe (they travel the wire).
    """

    def __init__(
        self,
        addresses: Sequence[Tuple[str, int]],
        *,
        bo_config: Optional[BOConfig] = None,
        snapshot_every: int = 8,
        snapshot_frame_bytes: Optional[int] = None,
        connect_timeout: float = 5.0,
        call_timeout: float = 120.0,
    ):
        if not addresses:
            raise ValueError("RemoteService needs at least one replica address")
        self.addresses = [tuple(a) for a in addresses]
        self.default_bo_config = bo_config
        self.snapshot_every = int(snapshot_every)
        self.snapshot_frame_bytes = (
            None if snapshot_frame_bytes is None else int(snapshot_frame_bytes)
        )
        self.connect_timeout = float(connect_timeout)
        self.call_timeout = float(call_timeout)
        self._handles: Dict[str, RemoteJobHandle] = {}

    @property
    def num_jobs(self) -> int:
        return len(self._handles)

    def job(self, name: str) -> RemoteJobHandle:
        return self._handles[name]

    def fetch_metrics(
        self, address: Optional[Tuple[str, int]] = None
    ) -> Dict[str, Any]:
        """Fetch one replica's telemetry dump via the read-only ``metrics``
        verb (no job, no lease). This reads the *replica's* registry over the
        wire for operators and tests; nothing here feeds back into any
        decision path. Returns ``{"metrics": ..., "service_stats": ...}``."""
        from repro_torch.core.rpc import MetricsReply, MetricsRequest

        addr = tuple(address) if address is not None else self.addresses[0]
        conn = _Connection(addr, self.connect_timeout, self.call_timeout)
        try:
            reply = conn.call(MetricsRequest())
        finally:
            conn.close()
        if isinstance(reply, ErrorReply):
            raise ProtocolError(reply.code, reply.message)
        assert isinstance(reply, MetricsReply)
        return {
            "metrics": reply.metrics,
            "service_stats": reply.service_stats,
        }

    def register_job(
        self,
        name: str,
        space: SearchSpace,
        *,
        suggester=None,
        bo_config: Optional[BOConfig] = None,
        seed: int = 0,
        warm_start: Optional[WarmStartPool] = None,
        fold_siblings: bool = True,
        metrics=None,
        multi_fidelity=None,
        max_cost=None,
    ) -> RemoteJobHandle:
        """Register a tuning job onto the fleet; same signature and handle
        surface as ``SelectionService.register_job``. Re-registering a name
        this client already holds takes over its own lease (the checkpoint
        restore path) and marks the old handle stale."""
        if suggester is not None and not isinstance(suggester, RemoteSuggester):
            raise ValueError(
                "RemoteService cannot ship a local suggester object across "
                "the process boundary; pass bo_config (or configure the "
                "replica's default) instead"
            )
        # a RemoteSuggester is this service's own shim (the Tuner hands it
        # back on checkpoint-restore re-registration): the replica-side
        # engine is service-created either way, so it is simply replaced.
        mf_wire = multi_fidelity
        if mf_wire is not None and not isinstance(mf_wire, dict):
            import dataclasses as _dc

            mf_wire = _dc.asdict(mf_wire)  # ASHAConfig → wire dict
        handle = RemoteJobHandle(
            self,
            name,
            space,
            bo_config or self.default_bo_config,
            seed,
            warm_start,
            fold_siblings,
            metrics=metrics,
            multi_fidelity=mf_wire,
            max_cost=max_cost,
        )
        prior = self._handles.get(name)
        if prior is not None and not prior.stale:
            handle._takeover = prior._lease
            handle._replica_idx = prior._replica_idx
            prior.stale = True
            prior.close()
        handle._readopt()
        handle._start_heartbeats()
        self._handles[name] = handle
        return handle
