"""Wire protocol of the cross-process SelectionService.

The paper's AMT is a managed service: tuning jobs talk to a fleet of
stateless API workers that lease work against durable state (PAPER.md §3-4),
not to an in-process object. This module is the transport-agnostic half of
that boundary: typed request/reply dataclasses plus an exact JSON-line codec.
The transport itself (TCP sockets, leases, failover) lives in
``repro_torch.distributed.engine_server`` / ``engine_client``; anything that
can move framed bytes can carry these messages.

The messages, their field order, the codec and both version numbers are
the JAX package's (``repro.core.rpc``): the same message encodes to the
same bytes in either package, and each decodes the other's. The backend
names inside a ``BOConfig`` wire image cross in the reference's spelling —
its ``"pallas"`` is this package's ``"kernel"``, its ``"xla"`` this
package's ``"torch"`` — and are mapped on the way in and out.

Versioning, and why there are *three* version-shaped checks:

* ``PROTOCOL_VERSION`` — the message schema. A peer speaking another version
  is refused at decode time (``ErrorCode.PROTOCOL_MISMATCH``) before any
  payload is interpreted.
* ``ENGINE_SNAPSHOT_VERSION`` — the engine-snapshot schema
  (``SelectionService.snapshot_job``). A replica refuses to adopt a snapshot
  it cannot reproduce bit-exactly (``ErrorCode.SNAPSHOT_MISMATCH``).
* **state/draw versions** — runtime monotonic counters, not schema versions.
  ``SuggestBatchRequest`` carries the client's view of the store
  (``store_version`` = observations pushed, plus the pending count) and the
  server refuses on mismatch (``ErrorCode.STALE_STATE``); snapshots carry the
  GPHP pool's ``version`` *and* a content fingerprint, and a replica whose
  resident pool disagrees refuses adoption (``ErrorCode.STALE_DRAWS``). In
  every case the failure mode is a loud refusal the client can route around,
  never a silently diverging suggestion stream.

All payloads are JSON-safe; arrays travel as exact base64 byte images
(``repro_torch.core.gp.serialize``), so the protocol preserves the engine's
bit-equivalence contract end to end.

**Snapshot compression** (negotiated, never assumed): engine snapshots grow
O(n) with the observation count, and the client baseline-refresh path
fetches one every ``snapshot_every`` requests. ``SnapshotRequest`` carries
``accept_codecs`` — the frame codecs the *client* can decode — and the
server replies with the best codec both sides support (server preference:
zstd, then zlib, then none), tagging the reply with ``codec``. A client
that advertises nothing gets the plain JSON object. Note what this
negotiation is and is not: it is a *capability* negotiation between
same-protocol-version peers — one side missing the optional ``zstandard``
module (gated) still interoperates, falling back
to zlib or plain JSON — not cross-version compatibility; peers at a
different ``PROTOCOL_VERSION`` are still refused at decode time like any
other message. Compression wraps the *already exact* JSON bytes, so the
bit-equivalence contract is untouched.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import zlib
from typing import Any, Dict, List, Optional, Type, Union

from repro_torch.core.gp.empirical_bayes import EmpiricalBayesConfig
from repro_torch.core.gp.slice_sampler import SliceSamplerConfig
from repro_torch.core.optimize_acq import AcqOptConfig
from repro_torch.core.suggest import BOConfig

__all__ = [
    "PROTOCOL_VERSION",
    "ENGINE_SNAPSHOT_VERSION",
    "ErrorCode",
    "ProtocolError",
    "RegisterRequest",
    "RegisterReply",
    "SuggestBatchRequest",
    "SuggestBatchReply",
    "ObserveRequest",
    "ObserveReply",
    "ReportRungRequest",
    "ReportRungReply",
    "PromotionRequest",
    "PromotionReply",
    "HeartbeatRequest",
    "HeartbeatReply",
    "SnapshotRequest",
    "SnapshotReply",
    "EngineStateRequest",
    "EngineStateReply",
    "EngineRestoreRequest",
    "EngineRestoreReply",
    "MetricsRequest",
    "MetricsReply",
    "ErrorReply",
    "encode_message",
    "decode_message",
    "bo_config_to_wire",
    "bo_config_from_wire",
    "available_snapshot_codecs",
    "encode_snapshot_frame",
    "decode_snapshot_frame",
    "encode_snapshot_frames",
    "decode_snapshot_frames",
]

#: Message-schema version. Bumped on any incompatible change to the
#: dataclasses below; peers at different versions refuse each other.
#: v2: multi-metric fields (``RegisterRequest.metric_specs``,
#: ``ObserveRequest.ys``) + snapshot-compression negotiation
#: (``SnapshotRequest.accept_codecs`` / ``SnapshotReply.codec``).
#: v3: chunked snapshot frames (``SnapshotRequest.max_frame_bytes`` /
#: ``SnapshotReply.frames``) so large-n store images stream in bounded
#: pieces instead of one message-sized blob.
#: v4: multi-fidelity verbs — ``report_rung`` (in-service ASHA promote/stop
#: decisions) and ``promotion`` (rung-table readback) — plus
#: ``RegisterRequest.multi_fidelity`` (the job's ASHA config wire dict).
#: v5: cost/budget fields — ``RegisterRequest.max_cost`` (the job's budget
#: cap), ``ObserveRequest.cost`` (per-observation trial cost) and the
#: ``"charge"`` observe kind (budget spend without a store row, e.g. failed
#: trials), plus the ``budget-exhausted`` refusal code.
#: v6: the read-only ``metrics`` observability verb — ``MetricsRequest``
#: (no job, no lease: it reads the replica's telemetry registry, never
#: engine state) and ``MetricsReply`` (the registry dump + service stats).
PROTOCOL_VERSION = 6

#: Engine-snapshot schema version (``SelectionService.snapshot_job`` output).
#: v2: ``metrics`` (the job's MetricSpec list) + the store's ``own_yx``
#: metric block.
#: v3: subset-backend cache fields (``inducing_sel``/``inducing_n0``) and
#: per-head GPHP state (``head_samples``/``head_n``, per-head chain states)
#: so a restoring replica replays the inducing-set construction and head
#: chains bit-exactly.
#: v4: ``multi_fidelity`` (ASHA config + rung tables + memoized decisions)
#: and the store's ``own_keys`` row-key list (rows join rung tables by
#: trial id).
#: v5: the store's ``own_costs`` per-row trial-cost list and the
#: suggester's ``budget`` ledger state (``{"max_cost", "spent"}``) — both
#: keys present only on jobs that track cost, so cost-off snapshots are
#: byte-identical to v4 content under the v5 tag.
ENGINE_SNAPSHOT_VERSION = 5


# --------------------------------------------------------------------------
# snapshot frame compression (capability-negotiated)
# --------------------------------------------------------------------------

try:  # optional dependency — gated, never required
    import zstandard as _zstd
except ImportError:  # pragma: no cover - environment-dependent
    _zstd = None


def available_snapshot_codecs() -> List[str]:
    """Frame codecs this process can encode *and* decode, in server
    preference order. ``zstd`` appears only when the optional ``zstandard``
    module is importable; ``zlib`` (stdlib) is always available."""
    codecs = []
    if _zstd is not None:
        codecs.append("zstd")
    codecs.append("zlib")
    return codecs


def encode_snapshot_frame(snapshot: Dict[str, Any], codec: str) -> str:
    """Compress a snapshot object into a base64 frame with ``codec``
    (``"zstd"`` | ``"zlib"``). The JSON bytes inside the frame are the same
    exact encoding the plain path ships, so decompress→parse is
    bit-equivalent to never compressing."""
    raw = json.dumps(snapshot, separators=(",", ":")).encode("utf-8")
    if codec == "zstd":
        if _zstd is None:
            raise ValueError("zstd codec unavailable in this process")
        comp = _zstd.ZstdCompressor().compress(raw)
    elif codec == "zlib":
        comp = zlib.compress(raw, level=6)
    else:
        raise ValueError(f"unknown snapshot codec {codec!r}")
    return base64.b64encode(comp).decode("ascii")


def decode_snapshot_frame(frame: str, codec: str) -> Dict[str, Any]:
    """Inverse of ``encode_snapshot_frame``."""
    comp = base64.b64decode(frame)
    if codec == "zstd":
        if _zstd is None:
            raise ValueError("zstd codec unavailable in this process")
        raw = _zstd.ZstdDecompressor().decompress(comp)
    elif codec == "zlib":
        raw = zlib.decompress(comp)
    else:
        raise ValueError(f"unknown snapshot codec {codec!r}")
    return json.loads(raw)


def encode_snapshot_frames(
    snapshot: Dict[str, Any], codec: str, max_frame_bytes: int
) -> List[str]:
    """Chunked variant of ``encode_snapshot_frame`` for large-n snapshots:
    compress the exact JSON bytes *once*, then split the compressed stream
    into ≤ ``max_frame_bytes`` pieces, base64-ing each. The receiver joins
    the decoded pieces and decompresses the whole stream, so the result is
    byte-identical to the single-frame path — chunking only bounds the size
    of any one wire string."""
    if max_frame_bytes <= 0:
        raise ValueError("max_frame_bytes must be positive")
    raw = json.dumps(snapshot, separators=(",", ":")).encode("utf-8")
    if codec == "zstd":
        if _zstd is None:
            raise ValueError("zstd codec unavailable in this process")
        comp = _zstd.ZstdCompressor().compress(raw)
    elif codec == "zlib":
        comp = zlib.compress(raw, level=6)
    else:
        raise ValueError(f"unknown snapshot codec {codec!r}")
    return [
        base64.b64encode(comp[i : i + max_frame_bytes]).decode("ascii")
        for i in range(0, max(len(comp), 1), max_frame_bytes)
    ]


def decode_snapshot_frames(frames: List[str], codec: str) -> Dict[str, Any]:
    """Inverse of ``encode_snapshot_frames``: join the decoded chunks,
    decompress the whole stream, parse."""
    comp = b"".join(base64.b64decode(f) for f in frames)
    if codec == "zstd":
        if _zstd is None:
            raise ValueError("zstd codec unavailable in this process")
        raw = _zstd.ZstdDecompressor().decompress(comp)
    elif codec == "zlib":
        raw = zlib.decompress(comp)
    else:
        raise ValueError(f"unknown snapshot codec {codec!r}")
    return json.loads(raw)


class ErrorCode:
    """Refusal codes carried by ``ErrorReply``. Matching on these (not on
    message strings) is the supported way for a client to react."""

    PROTOCOL_MISMATCH = "protocol-mismatch"  # peer speaks another schema
    SNAPSHOT_MISMATCH = "snapshot-version-mismatch"  # unadoptable snapshot
    UNKNOWN_JOB = "unknown-job"  # request for a job this replica never saw
    LEASE_EXPIRED = "lease-expired"  # lease TTL elapsed; re-register to adopt
    LEASE_HELD = "lease-held"  # another live lease owns the job
    STALE_STATE = "stale-state"  # client/server store versions disagree
    STALE_DRAWS = "stale-draws"  # resident GPHP pool conflicts with snapshot
    BUDGET_EXHAUSTED = "budget-exhausted"  # job's max_cost budget is spent
    BAD_REQUEST = "bad-request"  # malformed or unknown message


class ProtocolError(RuntimeError):
    """Raised on decode failure or when a peer replies with ``ErrorReply``.

    ``code`` is one of ``ErrorCode``; ``message`` is human-readable detail.
    ``retry_after`` (seconds) is set on refusals that resolve by waiting —
    currently ``LEASE_HELD``, where it is the held lease's remaining TTL.
    """

    def __init__(self, code: str, message: str,
                 retry_after: Optional[float] = None):
        super().__init__(f"[{code}] {message}")
        self.code = code
        self.message = message
        self.retry_after = retry_after


# --------------------------------------------------------------------------
# message dataclasses
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RegisterRequest:
    """Register (or adopt) a tuning job on an engine replica.

    Exactly one of two modes:
      * fresh registration — ``space_spec`` (``SearchSpace.to_spec``), the
        engine config (``bo_config_to_wire``), ``seed`` and optional
        warm-start pool state;
      * snapshot adoption — ``snapshot`` (``SelectionService.snapshot_job``
        output) carrying the complete engine state; the other fields are
        ignored in favour of the snapshot's own record of them.

    ``takeover_lease`` lets the *current lease holder* re-register its own
    job (checkpoint restore re-runs registration); without it, a register
    attempt against a live lease is refused with ``LEASE_HELD``.

    ``metric_specs`` (``MetricSet.to_wire``) declares a multi-metric job;
    ``multi_fidelity`` (the ASHA config as a field dict) turns on in-service
    ASHA promotion + per-rung acquisition heads for the job;
    ``max_cost`` caps the job's cumulative trial cost (the replica creates
    the budget ledger and refuses further ``suggest_batch`` requests with
    ``BUDGET_EXHAUSTED`` once it is spent);
    ``capabilities`` advertises optional client features — currently
    ``"snapshot-zstd"`` / ``"snapshot-zlib"`` (the compressed-snapshot
    codecs this client decodes; see the module docstring).
    """

    TYPE = "register"
    job_name: str
    space_spec: Optional[List[Dict[str, Any]]] = None
    seed: int = 0
    bo_config: Optional[Dict[str, Any]] = None
    warm_start_state: Optional[Dict[str, Any]] = None
    fold_siblings: bool = True
    snapshot: Optional[Dict[str, Any]] = None
    takeover_lease: Optional[str] = None
    metric_specs: Optional[List[Dict[str, Any]]] = None
    multi_fidelity: Optional[Dict[str, Any]] = None
    max_cost: Optional[float] = None
    capabilities: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class RegisterReply:
    """Grant: an opaque ``lease`` token (present on every subsequent request
    for the job) with a sliding ``lease_ttl`` (seconds), plus what the client
    mirror needs: the folded parent count and — when the service combined
    sibling histories in — the resulting warm-pool state.

    ``adopted_resident=True`` means a snapshot-register found the job still
    live on this replica (its lease had merely expired) and the lease was
    granted on the *resident* state instead of restoring the snapshot —
    ``store_version``/``num_pending``/``store_fingerprint`` describe that
    resident store so the client can verify it matches its mirror exactly
    (and skip the oplog replay)."""

    TYPE = "register_reply"
    lease: str
    lease_ttl: float
    num_parents: int
    pool_version: int
    warm_pool_state: Optional[Dict[str, Any]] = None
    adopted_resident: bool = False
    store_version: int = 0
    num_pending: int = 0
    store_fingerprint: Optional[str] = None
    # server-side optional features (snapshot codecs etc.) — the client
    # intersects these with its own to pick what to request.
    capabilities: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class SuggestBatchRequest:
    """One batched decision (fill ``k`` freed slots). ``store_version`` and
    ``num_pending`` are the client's view of the job store; the server
    refuses with ``STALE_STATE`` if its own store disagrees — a replica that
    missed an observation must never serve suggestions from stale data."""

    TYPE = "suggest_batch"
    job_name: str
    lease: str
    k: int
    store_version: int
    num_pending: int


@dataclasses.dataclass(frozen=True)
class SuggestBatchReply:
    TYPE = "suggest_batch_reply"
    configs: List[Dict[str, Any]]
    pool_version: int


@dataclasses.dataclass(frozen=True)
class ObserveRequest:
    """A store transition, mirrored to the replica in event order.

    ``kind`` selects the transition:
      * ``"push"`` — finished observation: encoded row ``x`` (exact byte
        image) + objective ``y``, or the full signed metric vector ``ys``
        (wire image of (M,) float64) for multi-metric jobs; ``cost`` carries
        the trial's cost (budget-tracking jobs) into the store's cost
        column — it does *not* charge the ledger (``"charge"`` does);
      * ``"charge"`` — ledger spend, one per terminal trial (failed trials
        charge too — the spend happened, there is just no row): ``cost``;
      * ``"pending"`` — candidate submitted: ``key`` + decoded ``config``;
      * ``"clear"`` — candidate reached terminality: ``key``.
    """

    TYPE = "observe"
    job_name: str
    lease: str
    kind: str
    x: Optional[Dict[str, Any]] = None
    y: Optional[float] = None
    key: Any = None
    config: Optional[Dict[str, Any]] = None
    ys: Optional[Dict[str, Any]] = None  # exact (M,) byte image, multi-metric
    cost: Optional[float] = None  # trial cost (budget-tracking jobs)


@dataclasses.dataclass(frozen=True)
class ObserveReply:
    TYPE = "observe_reply"
    accepted: bool
    store_version: int


@dataclasses.dataclass(frozen=True)
class ReportRungRequest:
    """A running trial crossed a rung boundary: trial ``key``, the crossing
    ``iteration``, and the trial's running-best ``value`` so far (already
    signed into the minimize convention). The replica records the value in
    the job's rung table (idempotently, keyed by trial) and returns the
    in-service ASHA decision; replays of a crossing the replica has already
    decided get the *memoized* original decision back."""

    TYPE = "report_rung"
    job_name: str
    lease: str
    key: Any
    iteration: int
    value: float


@dataclasses.dataclass(frozen=True)
class ReportRungReply:
    """``decision`` is ``"stop"`` or ``"continue"``; ``rung`` is the rung
    index the iteration landed on (−1 for a non-rung iteration)."""

    TYPE = "report_rung_reply"
    decision: str
    rung: int = -1


@dataclasses.dataclass(frozen=True)
class PromotionRequest:
    """Fetch the job's rung tables + memoized decisions
    (``MultiFidelityState.promotion``) — the readback the equality and
    failover tests compare across process boundaries."""

    TYPE = "promotion"
    job_name: str
    lease: str


@dataclasses.dataclass(frozen=True)
class PromotionReply:
    TYPE = "promotion_reply"
    state: Optional[Dict[str, Any]] = None  # None: job has no multi-fidelity


@dataclasses.dataclass(frozen=True)
class HeartbeatRequest:
    """Lease renewal for an idle job (any other request also renews)."""

    TYPE = "heartbeat"
    job_name: str
    lease: str


@dataclasses.dataclass(frozen=True)
class HeartbeatReply:
    TYPE = "heartbeat_reply"
    lease_ttl: float
    pool_version: int


@dataclasses.dataclass(frozen=True)
class SnapshotRequest:
    """Fetch the job's engine snapshot (``SelectionService.snapshot_job``).
    ``include_factors`` additionally ships the O(S·n²) posterior factor
    blocks; by default a restoring replica rehydrates them locally.
    ``accept_codecs`` lists the frame codecs the client decodes (e.g.
    ``["zstd", "zlib"]``); empty means "plain JSON only" — the server never
    compresses toward a client that did not ask. ``max_frame_bytes`` (with a
    negotiated codec) asks for the *chunked* reply shape: compressed bytes
    split into ≤ max_frame_bytes pieces in ``SnapshotReply.frames``, for
    large-n store images."""

    TYPE = "snapshot"
    job_name: str
    lease: str
    include_factors: bool = False
    accept_codecs: List[str] = dataclasses.field(default_factory=list)
    max_frame_bytes: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class SnapshotReply:
    """``codec=None``: ``snapshot`` is the plain JSON object. Otherwise,
    either ``frames`` carries the chunked compressed stream (decode with
    ``decode_snapshot_frames``; ``snapshot`` is then empty), or ``snapshot``
    is ``{"frame": <base64>}`` compressed with ``codec`` — decode with
    ``decode_snapshot_frame``."""

    TYPE = "snapshot_reply"
    snapshot: Dict[str, Any]
    codec: Optional[str] = None
    frames: Optional[List[str]] = None


@dataclasses.dataclass(frozen=True)
class EngineStateRequest:
    """Fetch just the job's ``BOSuggester.state_dict`` — the constant-size
    blob Tuner checkpoints need after every event. (A full ``snapshot``
    would carry the whole store as O(n) wire bytes.)"""

    TYPE = "engine_state"
    job_name: str
    lease: str


@dataclasses.dataclass(frozen=True)
class EngineStateReply:
    TYPE = "engine_state_reply"
    state: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class EngineRestoreRequest:
    """Install a checkpointed suggester state (``BOSuggester.state_dict``)
    into the registered job — the Tuner checkpoint-restore path in remote
    mode."""

    TYPE = "engine_restore"
    job_name: str
    lease: str
    suggester_state: Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class EngineRestoreReply:
    TYPE = "engine_restore_reply"
    ok: bool = True


@dataclasses.dataclass(frozen=True)
class MetricsRequest:
    """Read-only observability verb: fetch the replica's telemetry registry
    dump (counters/gauges/histograms) and service stats. Carries no job name
    and no lease — it renews nothing, mutates nothing, and reads *telemetry*
    state only (plus the service's own insight counters), never decision
    state. Serving it cannot perturb any suggestion stream."""

    TYPE = "metrics"


@dataclasses.dataclass(frozen=True)
class MetricsReply:
    """``metrics`` is ``Telemetry.metrics()`` (``{"enabled", "counters",
    "gauges", "histograms"}``); ``service_stats`` is
    ``SelectionService.stats()`` (arena residency + per-group pool
    counters)."""

    TYPE = "metrics_reply"
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)
    service_stats: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class ErrorReply:
    """Loud refusal: ``code`` is an ``ErrorCode`` the client matches on.
    ``retry_after`` (seconds) accompanies refusals that resolve by waiting
    (``LEASE_HELD``: the held lease's remaining TTL — a crashed holder's job
    becomes adoptable exactly then; a live holder will have renewed)."""

    TYPE = "error"
    code: str
    message: str
    retry_after: Optional[float] = None


Message = Union[
    RegisterRequest,
    RegisterReply,
    SuggestBatchRequest,
    SuggestBatchReply,
    ObserveRequest,
    ObserveReply,
    ReportRungRequest,
    ReportRungReply,
    PromotionRequest,
    PromotionReply,
    HeartbeatRequest,
    HeartbeatReply,
    SnapshotRequest,
    SnapshotReply,
    EngineStateRequest,
    EngineStateReply,
    EngineRestoreRequest,
    EngineRestoreReply,
    MetricsRequest,
    MetricsReply,
    ErrorReply,
]

_REGISTRY: Dict[str, Type[Any]] = {
    cls.TYPE: cls
    for cls in (
        RegisterRequest,
        RegisterReply,
        SuggestBatchRequest,
        SuggestBatchReply,
        ObserveRequest,
        ObserveReply,
        ReportRungRequest,
        ReportRungReply,
        PromotionRequest,
        PromotionReply,
        HeartbeatRequest,
        HeartbeatReply,
        SnapshotRequest,
        SnapshotReply,
        EngineStateRequest,
        EngineStateReply,
        EngineRestoreRequest,
        EngineRestoreReply,
        MetricsRequest,
        MetricsReply,
        ErrorReply,
    )
}


# --------------------------------------------------------------------------
# codec
# --------------------------------------------------------------------------


def encode_message(msg: Message) -> bytes:
    """Frame a message as one JSON line (newline-terminated UTF-8)."""
    obj = {
        "protocol": PROTOCOL_VERSION,
        "type": msg.TYPE,
        "body": dataclasses.asdict(msg),
    }
    return (json.dumps(obj, separators=(",", ":")) + "\n").encode("utf-8")


def decode_message(line: Union[bytes, str]) -> Message:
    """Parse one framed line back into its dataclass.

    Raises ``ProtocolError``:
      * ``PROTOCOL_MISMATCH`` if the peer speaks another schema version
        (checked before the body is interpreted; ``ErrorReply`` is exempt so
        a mismatch refusal itself stays readable);
      * ``BAD_REQUEST`` for malformed JSON or an unknown message type.
    """
    try:
        obj = json.loads(line)
        mtype = obj["type"]
    except (ValueError, KeyError, TypeError) as e:
        raise ProtocolError(ErrorCode.BAD_REQUEST, f"unparseable message: {e}")
    if mtype == ErrorReply.TYPE:
        try:
            return ErrorReply(**obj.get("body", {}))
        except TypeError as e:
            raise ProtocolError(ErrorCode.BAD_REQUEST, f"bad error body: {e}")
    version = obj.get("protocol")
    if version != PROTOCOL_VERSION:
        raise ProtocolError(
            ErrorCode.PROTOCOL_MISMATCH,
            f"peer speaks protocol v{version}, this process speaks "
            f"v{PROTOCOL_VERSION}",
        )
    cls = _REGISTRY.get(mtype)
    if cls is None:
        raise ProtocolError(ErrorCode.BAD_REQUEST, f"unknown message type {mtype!r}")
    try:
        return cls(**obj["body"])
    except (TypeError, KeyError) as e:
        raise ProtocolError(ErrorCode.BAD_REQUEST, f"bad {mtype} body: {e}")


# --------------------------------------------------------------------------
# config wire images
# --------------------------------------------------------------------------

# this package's backend names -> the reference's, and back
_TO_WIRE = {"kernel": "pallas", "torch": "xla"}
_FROM_WIRE = {wire: name for name, wire in _TO_WIRE.items()}


def bo_config_to_wire(cfg: BOConfig) -> Dict[str, Any]:
    """JSON-safe image of a ``BOConfig`` (nested NamedTuple configs flattened
    to field dicts), in the reference's schema. Round-trips through
    ``bo_config_from_wire`` to an equal config — the engine a replica builds
    from it walks the same GPHP chain."""
    acq = cfg.acq._asdict()
    acq["backend"] = _TO_WIRE[acq["backend"]]
    return {
        "num_init": cfg.num_init,
        "gphp_method": cfg.gphp_method,
        "slice_config": cfg.slice_config._asdict(),
        "eb_config": cfg.eb_config._asdict(),
        "acq": acq,
        "pending_strategy": cfg.pending_strategy,
        "liar_value": cfg.liar_value,
        "dedupe_tol": cfg.dedupe_tol,
        "max_pending": cfg.max_pending,
        "refit_every": cfg.refit_every,
        "incremental": cfg.incremental,
        "fit_backend": _TO_WIRE[cfg.fit_backend],
        "num_scalarizations": cfg.num_scalarizations,
        "fantasy_block": cfg.fantasy_block,
        "posterior_backend": cfg.posterior_backend,
        "n_switch": cfg.n_switch,
        "max_inducing": cfg.max_inducing,
        "per_head_gphp": cfg.per_head_gphp,
        "cost_aware": cfg.cost_aware,
        "cost_cooling": cfg.cost_cooling,
    }


def bo_config_from_wire(blob: Dict[str, Any]) -> BOConfig:
    """Inverse of ``bo_config_to_wire`` (this package's image or the JAX
    package's)."""
    acq = dict(blob["acq"])
    acq["backend"] = _FROM_WIRE[acq["backend"]]
    return BOConfig(
        num_init=int(blob["num_init"]),
        gphp_method=blob["gphp_method"],
        slice_config=SliceSamplerConfig(**blob["slice_config"]),
        eb_config=EmpiricalBayesConfig(**blob["eb_config"]),
        acq=AcqOptConfig(**acq),
        pending_strategy=blob["pending_strategy"],
        liar_value=float(blob["liar_value"]),
        dedupe_tol=float(blob["dedupe_tol"]),
        max_pending=int(blob["max_pending"]),
        refit_every=int(blob["refit_every"]),
        incremental=bool(blob["incremental"]),
        fit_backend=_FROM_WIRE[blob["fit_backend"]],
        num_scalarizations=int(blob.get("num_scalarizations", 16)),
        fantasy_block=bool(blob.get("fantasy_block", False)),
        posterior_backend=blob.get("posterior_backend", "exact"),
        n_switch=int(blob.get("n_switch", 2048)),
        max_inducing=int(blob.get("max_inducing", 1024)),
        per_head_gphp=bool(blob.get("per_head_gphp", False)),
        cost_aware=bool(blob.get("cost_aware", False)),
        cost_cooling=float(blob.get("cost_cooling", 1.0)),
    )
