"""Engine replica: a ``SelectionService`` served over a TCP socket.

This is the server half of the cross-process selection service (paper §3-4:
tuning jobs talk to a fleet of decision-engine workers, not to an in-process
object). One ``EngineServer`` hosts one ``SelectionService`` — the same
multi-tenant engine in-process callers use — behind the versioned wire
protocol of ``repro_torch.core.rpc`` (the JAX package's messages and bytes),
and adds the one thing a fleet needs that a library does not: **leases**.

Lease model:

  * ``register`` grants an opaque lease token with a sliding TTL; every
    subsequent request for the job must present it and renews it.
  * A request with a wrong/expired token is refused loudly
    (``lease-expired``) — the client's recovery is to re-register with its
    last snapshot: if this replica still hosts the live job, the lease is
    granted on the *resident* state (fingerprint-verified by the client, no
    replay needed); otherwise the snapshot is restored and the client
    replays its oplog.
  * A ``register`` against a *live* lease held by someone else is refused
    (``lease-held``) unless the request proves ownership via
    ``takeover_lease`` — so a crashed client's job becomes adoptable exactly
    when its lease runs out, and two clients can never both drive one job.
  * Replica death needs no protocol at all: the client observes the dead
    socket and re-adopts on a sibling replica from its last published
    snapshot (``SelectionService.restore_job``), which refuses with
    ``stale-draws`` if that replica's resident GPHP pool conflicts.

Transport: newline-framed JSON over TCP (stdlib ``socketserver``), one
persistent connection per client, engine work serialized under one lock (the
engine itself is the bottleneck, not the framing). The replica's engines
run on the CUDA card; ``--device cpu`` (``EngineServer(device="cpu")``) is
the only way to serve from the CPU. Run a replica from the CLI::

    PYTHONPATH=src python -m repro_torch.distributed.engine_server --port 7341

``--port 0`` picks a free port; the first line the replica prints names the
address it listens on (``engine replica listening on HOST:PORT ...``).
"""

from __future__ import annotations

import argparse
import socketserver
import threading
import time
import uuid
from typing import Any, Dict, Optional, Tuple

from repro_torch.core import telemetry
from repro_torch.core.device import resolve_device
from repro_torch.core.rpc import (
    EngineRestoreReply,
    EngineRestoreRequest,
    EngineStateReply,
    EngineStateRequest,
    ErrorCode,
    ErrorReply,
    HeartbeatReply,
    HeartbeatRequest,
    MetricsReply,
    MetricsRequest,
    ObserveReply,
    ObserveRequest,
    PromotionReply,
    PromotionRequest,
    ProtocolError,
    RegisterReply,
    RegisterRequest,
    ReportRungReply,
    ReportRungRequest,
    SnapshotReply,
    SnapshotRequest,
    SuggestBatchReply,
    SuggestBatchRequest,
    bo_config_from_wire,
    decode_message,
    encode_message,
)
from repro_torch.core.search_space import SearchSpace
from repro_torch.core.service import (
    PoolConflictError,
    SelectionService,
    ServiceConfig,
    SnapshotVersionError,
)
from repro_torch.core.warm_start import WarmStartPool

__all__ = ["EngineServer", "DEFAULT_LEASE_TTL", "main"]

DEFAULT_LEASE_TTL = 30.0


class _Lease:
    __slots__ = ("token", "expires_at")

    def __init__(self, token: str, expires_at: float):
        self.token = token
        self.expires_at = expires_at


class EngineServer:
    """One engine replica: ``SelectionService`` + lease table + TCP front.

    Args:
        host/port: bind address (port 0 picks a free port; read it back from
            ``address``).
        service_config: the hosted ``SelectionService``'s config. Every
            replica of one fleet must run the same config (snapshots record
            it for debugging, adoption does not re-negotiate it).
        lease_ttl: sliding per-job lease lifetime in seconds. Any valid
            request for a job renews its lease; a job idle longer than this
            becomes adoptable by another client.
        clock: monotonic time source (injectable for lease tests).
        device: where the hosted engines run: ``None`` is the CUDA card (a
            ``RuntimeError`` here if none is visible), ``"cpu"`` the CPU.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        service_config: Optional[ServiceConfig] = None,
        lease_ttl: float = DEFAULT_LEASE_TTL,
        clock=time.monotonic,
        device=None,
    ):
        self.device = resolve_device(device)
        self.service = SelectionService(
            service_config or ServiceConfig(), device=self.device
        )
        self.lease_ttl = float(lease_ttl)
        self._clock = clock
        self._lock = threading.RLock()
        self._leases: Dict[str, _Lease] = {}
        server = self

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:
                for line in self.rfile:
                    if not line.strip():
                        continue
                    try:
                        self.wfile.write(server._serve_line(line))
                        self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError):
                        return

        class _TCP(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._tcp = _TCP((host, port), _Handler)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle
    @property
    def address(self) -> Tuple[str, int]:
        """The bound ``(host, port)`` — what clients connect to."""
        return self._tcp.server_address[:2]

    def start(self) -> "EngineServer":
        """Serve in a daemon thread; returns self (``with``-style chaining)."""
        self._thread = threading.Thread(
            target=self._tcp.serve_forever, name="engine-server", daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        """Serve on the calling thread (CLI entry point)."""
        self._tcp.serve_forever()

    def shutdown(self) -> None:
        """Stop serving and close the listening socket. In tests this stands
        in for a replica crash: live client connections die with it."""
        self._tcp.shutdown()
        self._tcp.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "EngineServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ------------------------------------------------------------- dispatch
    def _serve_line(self, line: bytes) -> bytes:
        try:
            msg = decode_message(line)
        except ProtocolError as e:
            telemetry.count("server.refusal." + e.code)
            return encode_message(
                ErrorReply(code=e.code, message=e.message,
                           retry_after=e.retry_after)
            )
        verb = getattr(msg, "TYPE", "unknown")
        with telemetry.span("rpc." + verb):
            try:
                with self._lock:
                    reply = self._dispatch(msg)
            except ProtocolError as e:
                reply = ErrorReply(code=e.code, message=e.message,
                                   retry_after=e.retry_after)
            except Exception as e:  # noqa: BLE001 — refuse loudly, never hang
                reply = ErrorReply(
                    code=ErrorCode.BAD_REQUEST, message=f"{type(e).__name__}: {e}"
                )
        out = encode_message(reply)
        if telemetry.enabled():
            telemetry.count("server.rpc." + verb)
            telemetry.observe("server.frame_bytes.in", len(line))
            telemetry.observe("server.frame_bytes.out", len(out))
            if isinstance(reply, ErrorReply):
                telemetry.count("server.refusal." + reply.code)
        return out

    def _dispatch(self, msg: Any) -> Any:
        if isinstance(msg, MetricsRequest):
            # Read-only observability verb — no job, no lease, no renewal.
            # The one sanctioned telemetry read in the serving path: the
            # dump goes out on the wire, never into engine state.
            return MetricsReply(
                metrics=telemetry.get().metrics(),  # invariant: telemetry-read -- serving the read-only metrics verb; the dump is exported to the wire and never feeds a decision
                service_stats=self.service.stats(),
            )
        if isinstance(msg, RegisterRequest):
            return self._register(msg)
        if isinstance(msg, SuggestBatchRequest):
            return self._suggest(msg)
        if isinstance(msg, ObserveRequest):
            return self._observe(msg)
        if isinstance(msg, ReportRungRequest):
            handle = self._checked(msg.job_name, msg.lease)
            if handle.multi_fidelity is None:
                return ReportRungReply(decision="continue", rung=-1)
            decision, rung = handle.multi_fidelity.report_rung(
                msg.key, int(msg.iteration), float(msg.value)
            )
            return ReportRungReply(decision=decision, rung=rung)
        if isinstance(msg, PromotionRequest):
            handle = self._checked(msg.job_name, msg.lease)
            return PromotionReply(state=handle.promotion())
        if isinstance(msg, HeartbeatRequest):
            handle = self._checked(msg.job_name, msg.lease)
            pool = self.service.group_pool(handle.name)
            return HeartbeatReply(lease_ttl=self.lease_ttl, pool_version=pool.version)
        if isinstance(msg, SnapshotRequest):
            self._checked(msg.job_name, msg.lease)
            snap = self.service.snapshot_job(
                msg.job_name, include_factors=msg.include_factors
            )
            # codec negotiation: best codec both peers support, in server
            # preference order; a client that advertised nothing (or lacks
            # the optional zstd module) still gets a frame it can decode —
            # plain JSON in the limit. Same-protocol capability negotiation,
            # not cross-version compat (version mismatch refuses earlier).
            from repro_torch.core.rpc import (
                available_snapshot_codecs,
                encode_snapshot_frame,
                encode_snapshot_frames,
            )

            for codec in available_snapshot_codecs():
                if codec in msg.accept_codecs:
                    if msg.max_frame_bytes:
                        # chunked shape: large-n store images stream as
                        # bounded pieces of one compressed byte stream.
                        return SnapshotReply(
                            snapshot={},
                            codec=codec,
                            frames=encode_snapshot_frames(
                                snap, codec, int(msg.max_frame_bytes)
                            ),
                        )
                    return SnapshotReply(
                        snapshot={"frame": encode_snapshot_frame(snap, codec)},
                        codec=codec,
                    )
            return SnapshotReply(snapshot=snap)
        if isinstance(msg, EngineStateRequest):
            handle = self._checked(msg.job_name, msg.lease)
            return EngineStateReply(state=handle.suggester.state_dict())
        if isinstance(msg, EngineRestoreRequest):
            handle = self._checked(msg.job_name, msg.lease)
            handle.suggester.load_state_dict(msg.suggester_state)
            return EngineRestoreReply()
        raise ProtocolError(
            ErrorCode.BAD_REQUEST, f"unexpected message type {getattr(msg, 'TYPE', '?')!r}"
        )

    # ---------------------------------------------------------------- leases
    def _checked(self, job_name: str, token: str):
        """Validate job + lease, renew the sliding TTL, return the handle."""
        try:
            handle = self.service.job(job_name)
        except KeyError:
            raise ProtocolError(
                ErrorCode.UNKNOWN_JOB, f"job {job_name!r} is not registered here"
            )
        lease = self._leases.get(job_name)
        now = self._clock()
        if lease is not None and now > lease.expires_at:
            # dispatch already serializes handlers, but the lease table's
            # guard is the re-entrant lock itself — keep it lexical.
            with self._lock:
                del self._leases[job_name]
            lease = None
            telemetry.count("server.lease.expired")
        if lease is None or lease.token != token:
            raise ProtocolError(
                ErrorCode.LEASE_EXPIRED,
                f"no live lease with this token for job {job_name!r}; "
                "re-register to adopt",
            )
        lease.expires_at = now + self.lease_ttl
        telemetry.count("server.lease.renew")
        return handle

    # -------------------------------------------------------------- handlers
    def _register(self, msg: RegisterRequest) -> RegisterReply:
        now = self._clock()
        lease = self._leases.get(msg.job_name)
        if lease is not None and now > lease.expires_at:
            with self._lock:
                del self._leases[msg.job_name]
            lease = None
            telemetry.count("server.lease.expired")
        if lease is not None and msg.takeover_lease != lease.token:
            remaining = lease.expires_at - now
            raise ProtocolError(
                ErrorCode.LEASE_HELD,
                f"job {msg.job_name!r} is leased for another "
                f"{remaining:.1f}s; adopt after expiry",
                retry_after=remaining,
            )
        adopted_resident = False
        if msg.snapshot is not None:
            resident = self.service._jobs.get(msg.job_name)
            if resident is not None:
                # The job is still live here — its lease merely lapsed (or
                # its holder is re-registering). Restoring the snapshot would
                # wipe state that is strictly *ahead* of it (the snapshot is
                # a past baseline) and can spuriously refuse on the pool
                # check (the resident pool advanced because of this very
                # job). Grant the lease on the resident state instead; the
                # reply's store fingerprint lets the client verify that
                # resident state matches its mirror exactly before trusting
                # it.
                handle = resident
                adopted_resident = True
            else:
                try:
                    handle = self.service.restore_job(msg.snapshot)
                except SnapshotVersionError as e:
                    raise ProtocolError(ErrorCode.SNAPSHOT_MISMATCH, str(e))
                except PoolConflictError as e:
                    raise ProtocolError(ErrorCode.STALE_DRAWS, str(e))
        else:
            if msg.space_spec is None:
                raise ProtocolError(
                    ErrorCode.BAD_REQUEST,
                    "register needs either space_spec or snapshot",
                )
            warm = None
            if msg.warm_start_state:
                warm = WarmStartPool()
                warm.load_state_dict(msg.warm_start_state)
            from repro_torch.core.multimetric import MetricSet

            handle = self.service.register_job(
                msg.job_name,
                SearchSpace.from_spec(msg.space_spec),
                bo_config=None
                if msg.bo_config is None
                else bo_config_from_wire(msg.bo_config),
                seed=int(msg.seed),
                warm_start=warm,
                fold_siblings=msg.fold_siblings,
                metrics=MetricSet.from_wire(msg.metric_specs),
                multi_fidelity=msg.multi_fidelity,
                max_cost=msg.max_cost,
            )
        token = uuid.uuid4().hex  # invariant: entropy -- lease tokens are opaque capabilities echoed back by the holder; they never enter decision state, snapshots, or the oplog
        with self._lock:
            self._leases[msg.job_name] = _Lease(token, now + self.lease_ttl)
        pool = self.service.group_pool(msg.job_name)
        from repro_torch.core.rpc import available_snapshot_codecs

        return RegisterReply(
            lease=token,
            lease_ttl=self.lease_ttl,
            num_parents=handle.store.num_parents,
            pool_version=pool.version,
            warm_pool_state=None
            if handle.warm_pool is None
            else handle.warm_pool.state_dict(),
            adopted_resident=adopted_resident,
            store_version=handle.store.num_observations,
            num_pending=handle.store.num_pending,
            store_fingerprint=handle.store.fingerprint(),
            capabilities=[f"snapshot-{c}" for c in available_snapshot_codecs()],
        )

    def _suggest(self, msg: SuggestBatchRequest) -> SuggestBatchReply:
        handle = self._checked(msg.job_name, msg.lease)
        store = handle.store
        if (
            msg.store_version != store.num_observations
            or msg.num_pending != store.num_pending
        ):
            raise ProtocolError(
                ErrorCode.STALE_STATE,
                f"client sees store=({msg.store_version} obs, "
                f"{msg.num_pending} pending), replica holds "
                f"({store.num_observations} obs, {store.num_pending} pending) "
                "— refusing to suggest from diverged state",
            )
        from repro_torch.core.budget import BudgetExhaustedError

        try:
            configs = handle.suggest_batch(msg.k)
        except BudgetExhaustedError as e:
            # typed refusal (the generic handler would blur it into
            # bad-request); the client maps it back to BudgetExhaustedError.
            raise ProtocolError(ErrorCode.BUDGET_EXHAUSTED, str(e))
        pool = self.service.group_pool(msg.job_name)
        return SuggestBatchReply(configs=configs, pool_version=pool.version)

    def _observe(self, msg: ObserveRequest) -> ObserveReply:
        from repro_torch.core.gp.serialize import array_from_wire

        handle = self._checked(msg.job_name, msg.lease)
        store = handle.store
        if msg.kind == "push":
            if msg.ys is not None:  # multi-metric: full signed vector
                accepted = store.push_vector_encoded(
                    array_from_wire(msg.x), array_from_wire(msg.ys), key=msg.key
                )
            else:
                accepted = store.push_encoded(
                    array_from_wire(msg.x), float(msg.y), key=msg.key,
                    cost=msg.cost,
                )
        elif msg.kind == "charge":
            # ledger spend: the *only* path that charges the budget (push's
            # ``cost`` lands in the store column, it never charges — the
            # client sends one charge per terminal trial, rows or not).
            if handle.budget_ledger is not None and msg.cost is not None:
                handle.budget_ledger.charge(float(msg.cost))
            accepted = True
        elif msg.kind == "pending":
            store.mark_pending(msg.key, msg.config)
            accepted = True
        elif msg.kind == "clear":
            store.clear_pending(msg.key)
            accepted = True
        else:
            raise ProtocolError(
                ErrorCode.BAD_REQUEST, f"unknown observe kind {msg.kind!r}"
            )
        return ObserveReply(accepted=accepted, store_version=store.num_observations)


def main(argv=None) -> None:
    """CLI: run one engine replica until interrupted."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 picks a free port (printed on startup)")
    ap.add_argument("--lease-ttl", type=float, default=DEFAULT_LEASE_TTL)
    ap.add_argument("--arena-budget-mb", type=float, default=256.0)
    ap.add_argument("--no-share-gphp", action="store_true")
    ap.add_argument("--no-sibling-warm-start", action="store_true")
    ap.add_argument("--telemetry", action="store_true",
                    help="enable the telemetry registry (same as "
                         "REPRO_TELEMETRY=1); serve live counters via the "
                         "read-only `metrics` verb")
    ap.add_argument("--device", default=None,
                    help="where the engines run: the CUDA card by default; "
                         "'cpu' serves from the CPU")
    args = ap.parse_args(argv)
    if args.telemetry:
        telemetry.set_enabled(True)
    server = EngineServer(
        args.host,
        args.port,
        service_config=ServiceConfig(
            arena_budget_mb=args.arena_budget_mb,
            share_gphp=not args.no_share_gphp,
            sibling_warm_start=not args.no_sibling_warm_start,
        ),
        lease_ttl=args.lease_ttl,
        device=args.device,
    )
    host, port = server.address
    print(f"engine replica listening on {host}:{port} "
          f"(lease ttl {server.lease_ttl:.0f}s, device {server.device})",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
