"""Process-local telemetry: counters, gauges, histograms, tracing spans.

Observation only, never decision state
--------------------------------------

This module is the one place in the engine allowed to read host-monotonic
time. That is safe *only* because telemetry obeys two invariants:

* **One-way flow** — decision-path modules (``suggest.py``, ``service.py``,
  the distributed layer, …) may *write* telemetry (``count``/``gauge``/
  ``observe``/``span``/``device_span``/``event``) but never read it back. No
  counter, histogram, or span ever influences a suggestion, a refit cadence,
  or a wire reply's payload. Telemetry-on and telemetry-off runs produce
  bit-identical suggestion streams (pinned by
  ``tests/test_torch_telemetry.py``).
* **Never serialized with state** — nothing here may appear in
  ``state_dict()`` / ``snapshot_job()`` / engine checkpoints. A restored
  engine starts with cold counters; replay equivalence is about decisions,
  not about observations of them.

Registry
--------

A single process-global :class:`Telemetry` registry (``telemetry.get()``)
backs the module-level convenience functions used at instrumentation sites::

    from repro_torch.core import telemetry

    telemetry.count("service.pool.hit")
    telemetry.gauge("arena.resident_bytes", arena.resident_bytes)
    with telemetry.span("suggest.decide", job=name, k=k):
        ...
    with telemetry.device_span("acq.refine", x.device, steps=25):
        ...  # waits for the card before it closes
    with telemetry.fenced_span("mamba2.ssd", x.device):
        ...  # waits for the card before it opens, too

Recording is off by default and costs one attribute load + one truth test
per site; enable it with the ``REPRO_TELEMETRY=1`` environment variable or
``telemetry.set_enabled(True)``. Spans nest through a thread-local stack, so
trace events carry parent/child edges; completed spans land in a bounded
ring buffer (oldest evicted first) and also feed a fixed-log-bucket duration
histogram ``span.<name>``. Read them with :meth:`Telemetry.trace_events`
and :meth:`Telemetry.metrics` (the benchmark's traced run drains both after
every call).

The clock is injectable (tests use a fake); the default is
``time.monotonic`` — host-monotonic is fine here precisely because none of
this ever feeds back into the engine. ``torch.profiler`` stamps device
events on the wall clock; a reader maps them onto this clock by the offset
between the two (``amt_bench/harness.py::DeviceTrace.to_mono``).
"""

from __future__ import annotations

import itertools
import math
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional

__all__ = [
    "Telemetry",
    "count",
    "device_span",
    "enabled",
    "enabled_from_env",
    "event",
    "fenced_span",
    "gauge",
    "get",
    "observe",
    "recording",
    "set_enabled",
    "span",
]

#: Environment flag consulted once at import; ``set_enabled`` overrides.
ENV_FLAG = "REPRO_TELEMETRY"

#: Log-bucket bounds: upper edges are 2**i seconds for i in [_BUCKET_LO,
#: _BUCKET_HI]. 2**-24 ≈ 60 ns, 2**24 ≈ 194 days — everything a tuning run
#: can plausibly time lands in a real bucket.
_BUCKET_LO = -24
_BUCKET_HI = 24


class _Histogram:
    """Fixed-log-bucket histogram: power-of-two upper edges, plus exact
    count/sum/min/max so averages stay accurate regardless of bucketing."""

    __slots__ = ("buckets", "n", "total", "vmin", "vmax")

    def __init__(self) -> None:
        self.buckets: Dict[int, int] = {}
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def record(self, value: float) -> None:
        v = float(value)
        if v <= 0.0:
            idx = _BUCKET_LO
        else:
            idx = min(max(math.ceil(math.log2(v)), _BUCKET_LO), _BUCKET_HI)
        self.buckets[idx] = self.buckets.get(idx, 0) + 1
        self.n += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def to_json(self) -> Dict[str, Any]:
        return {
            "count": self.n,
            "sum": self.total,
            "min": self.vmin if self.n else None,
            "max": self.vmax if self.n else None,
            "buckets": {
                f"le_2^{i}": self.buckets[i] for i in sorted(self.buckets)
            },
        }


class _NullSpan:
    """Shared no-op context manager returned while recording is disabled."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: object) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class Telemetry:
    """Monotonic counters + gauges + log-bucket histograms + span tracing.

    Thread-safe: the engine server mutates it from many handler threads.
    All mutation happens under one internal lock; reads return plain copies.
    """

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        trace_capacity: int = 4096,
        enabled: bool = False,
    ):
        self._clock = clock
        self._enabled = bool(enabled)
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._histograms: Dict[str, _Histogram] = {}
        self._trace: deque = deque(maxlen=int(trace_capacity))
        self._ids = itertools.count(1)
        self._stack = threading.local()

    # ------------------------------------------------------------- control

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, on: bool) -> None:
        self._enabled = bool(on)

    def reset(self) -> None:
        """Drop every counter, gauge, histogram, and trace event."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._trace.clear()
            self._ids = itertools.count(1)

    # ------------------------------------------------------------- writing

    def count(self, name: str, n: int = 1) -> None:
        """Increment the monotonic counter ``name`` by ``n``."""
        if not self._enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def gauge(self, name: str, value: float) -> None:
        """Set the gauge ``name`` to its latest ``value``."""
        if not self._enabled:
            return
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        """Record ``value`` into the log-bucket histogram ``name``."""
        if not self._enabled:
            return
        with self._lock:
            hist = self._histograms.get(name)
            if hist is None:
                hist = self._histograms[name] = _Histogram()
            hist.record(value)

    def event(self, name: str, **attrs: Any) -> None:
        """Append a point event (no duration) to the trace ring."""
        if not self._enabled:
            return
        now = self._clock()
        with self._lock:
            self._trace.append({
                "kind": "event",
                "name": name,
                "span_id": next(self._ids),
                "parent_id": self._parent_id(),
                "t0": now,
                "t1": now,
                "thread": threading.get_ident(),
                "attrs": attrs,
            })

    def span(self, name: str, **attrs: Any):
        """Context manager timing a phase; nests via a thread-local stack.

        On exit the span lands in the trace ring (with its parent edge) and
        its duration feeds the ``span.<name>`` histogram. While disabled, a
        shared no-op context manager is returned so call sites stay cheap.
        """
        if not self._enabled:
            return _NULL_SPAN
        return self._live_span(name, attrs)

    def device_span(self, name: str, device: Any, **attrs: Any):
        """``span`` around work enqueued on ``device`` (a ``torch.device``):
        on a CUDA device it waits for the device before it closes, so it
        times the work and not just its enqueue. While disabled it returns
        the same shared no-op as ``span`` and waits for nothing."""
        if not self._enabled:
            return _NULL_SPAN
        return self._live_span(name, attrs, device)

    def recording(self, device: Any) -> bool:
        """True while recording is on and no CUDA stream of this thread
        captures a graph: the test for a site that would read a device value
        or wait for the device, neither of which a capture allows."""
        if not self._enabled:
            return False
        if getattr(device, "type", None) == "cuda":
            import torch

            return not torch.cuda.is_current_stream_capturing()
        return True

    def fenced_span(self, name: str, device: Any, **attrs: Any):
        """``device_span`` that also waits for ``device`` before it opens, so
        that the device work starting inside the span is the work launched
        inside it, which a device trace can then attribute to the span. The
        shared no-op while recording is off and while this thread's CUDA
        stream captures a graph (``recording``)."""
        if not self.recording(device):
            return _NULL_SPAN
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)
        return self._live_span(name, attrs, device)

    @contextmanager
    def _live_span(
        self, name: str, attrs: Dict[str, Any], device: Any = None
    ) -> Iterator[None]:
        with self._lock:
            span_id = next(self._ids)
        parent_id = self._parent_id()
        stack = self._ensure_stack()
        stack.append(span_id)
        t0 = self._clock()
        try:
            yield
            if device is not None and device.type == "cuda":
                import torch

                torch.cuda.synchronize(device)
        finally:
            t1 = self._clock()
            stack.pop()
            with self._lock:
                self._trace.append({
                    "kind": "span",
                    "name": name,
                    "span_id": span_id,
                    "parent_id": parent_id,
                    "t0": t0,
                    "t1": t1,
                    "dur": t1 - t0,
                    "thread": threading.get_ident(),
                    "attrs": attrs,
                })
                hist = self._histograms.get("span." + name)
                if hist is None:
                    hist = self._histograms["span." + name] = _Histogram()
                hist.record(t1 - t0)

    def _ensure_stack(self) -> List[int]:
        stack = getattr(self._stack, "ids", None)
        if stack is None:
            stack = self._stack.ids = []
        return stack

    def _parent_id(self) -> Optional[int]:
        stack = getattr(self._stack, "ids", None)
        return stack[-1] if stack else None

    # ------------------------------------------------------------- reading

    def metrics(self) -> Dict[str, Any]:
        """JSON-safe dump of counters, gauges, and histograms."""
        with self._lock:
            return {
                "enabled": self._enabled,
                "counters": dict(sorted(self._counters.items())),
                "gauges": dict(sorted(self._gauges.items())),
                "histograms": {
                    k: self._histograms[k].to_json()
                    for k in sorted(self._histograms)
                },
            }

    def trace_events(self) -> List[Dict[str, Any]]:
        """Copy of the trace ring, oldest first."""
        with self._lock:
            return [dict(e) for e in self._trace]


def enabled_from_env() -> bool:
    return os.environ.get(ENV_FLAG, "").strip().lower() in (
        "1", "true", "on", "yes",
    )


#: The process-global registry behind the module-level functions.
_GLOBAL = Telemetry(enabled=enabled_from_env())


def get() -> Telemetry:
    """The process-global registry (read side: the metrics verb, the
    benchmark's traced run, tests — never decision paths)."""
    return _GLOBAL


def set_enabled(on: bool) -> None:
    _GLOBAL.set_enabled(on)


def enabled() -> bool:
    """Cheap gate for instrumentation sites whose *argument* computation is
    non-trivial (e.g. summing arena residency). Branching on this flag is
    part of the write API: it decides whether to record, never what the
    engine decides."""
    return _GLOBAL.enabled


def count(name: str, n: int = 1) -> None:
    _GLOBAL.count(name, n)


def gauge(name: str, value: float) -> None:
    _GLOBAL.gauge(name, value)


def observe(name: str, value: float) -> None:
    _GLOBAL.observe(name, value)


def event(name: str, **attrs: Any) -> None:
    _GLOBAL.event(name, **attrs)


def span(name: str, **attrs: Any):
    return _GLOBAL.span(name, **attrs)


def device_span(name: str, device: Any, **attrs: Any):
    return _GLOBAL.device_span(name, device, **attrs)


def fenced_span(name: str, device: Any, **attrs: Any):
    return _GLOBAL.fenced_span(name, device, **attrs)


def recording(device: Any) -> bool:
    return _GLOBAL.recording(device)
