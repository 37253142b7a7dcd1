"""Shared pieces of the benchmark: finding a cell's files by name, seeds,
the traced run's instruments and the device trace's reduction.

Everything a cell needs is found by name: ``workloads/<cell>.json`` (the
traffic, its runner and its limits), ``configs/<config>.json`` (the
configuration), ``runners/<runner>.py`` (a general runner that many cells
share) and ``metrics/<metric>.py`` (one reader a metric). A new cell, metric
or configuration is therefore new files and a manifest entry; no file here
needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names that must not be loaded in a run: the JAX stack
#: and the JAX package the port was made from (``repro_torch`` is allowed:
#: names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def manifest() -> Dict[str, Any]:
    path = ROOT / "BENCHMARK.json"
    if not path.is_file():
        raise SystemExit(f"no BENCHMARK.json at {ROOT}")
    return load_json(path)


def cell_files(name: str, bench: Optional[Dict[str, Any]] = None):
    """(manifest entry, workload file, config file) of the cell ``name``."""
    bench = manifest() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config = next((c for c in bench["configs"] if c["name"] == entry["config"]), None)
    if config is None:
        raise SystemExit(f"workload {name!r} names an unknown config {entry['config']!r}")
    workload = load_json(BENCH / "workloads" / f"{name}.json")
    conf = load_json(ROOT / config["file"])
    return entry, workload, conf


def merged(base: Dict[str, Any], over: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """``base`` with ``over``'s keys replaced, nested dictionaries merged."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load_module(kind: str, name: str):
    """The module ``amt_bench/<kind>/<name>.py`` (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no {kind[:-1]} {name!r} ({path.relative_to(ROOT)})")
    mod_name = f"amt_bench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: Dict[str, Any], cell: str, trace: bool) -> List[Dict[str, Any]]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    tracing off, its per-layer metrics with tracing on."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def derive_seed(seed: int, *parts: int) -> int:
    """A 31-bit seed drawn from ``seed`` and ``parts`` (any whole numbers)."""
    import numpy as np

    words = [int(seed) % (1 << 64)] + [int(p) % (1 << 32) for p in parts]
    return int(np.random.SeedSequence(words).generate_state(1)[0]) & 0x7FFFFFFF


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class DeviceTrace:
    """A profiled window reduced to device intervals: ``ops`` holds (name,
    start_us, dur_us) of every kernel and copy on the device."""

    def __init__(self, ops, window_s: float):
        self.ops = sorted(ops, key=lambda o: o[1])
        self.window_s = window_s
        self.to_mono = 0.0  # seconds to add to the profiler's clock for time.monotonic
        self.gaps: List[List[Any]] = []

    @classmethod
    def from_profile(cls, prof, window_s: float) -> "DeviceTrace":
        import time

        ops = []
        for ev in prof.profiler.kineto_results.events():
            if str(ev.device_type()).split(".")[-1] == "CUDA":
                ops.append((ev.name(), ev.start_ns() / 1e3, ev.duration_ns() / 1e3))
        trace = cls(ops, window_s)
        # the profiler's clock: the wall clock or the monotonic one, whichever
        # the newest event lies closer to; spans are on the monotonic clock
        if ops:
            last = max(s + d for _, s, d in ops) / 1e6
            wall, mono = time.time(), time.monotonic()
            trace.to_mono = (mono - wall) if abs(last - wall) < abs(last - mono) else 0.0
        return trace

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union)."""
        total, end = 0.0, None
        for _, s, d in self.ops:
            e = s + d
            if end is None or s > end:
                total += d
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e6

    def time_of(self, pattern) -> float:
        """Device seconds of the operations whose name matches ``pattern``."""
        return sum(d for n, _, d in self.ops if pattern.search(n)) / 1e6

    def top_ops(self, k: int = 10) -> List[List[Any]]:
        by: Dict[str, float] = {}
        for n, _, d in self.ops:
            by[n] = by.get(n, 0.0) + d / 1e6
        return [[n[:160], s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def name_gaps(self, spans: List[Dict[str, Any]], k: int = 10) -> None:
        """The ``k`` longest gaps between device operations, each named by
        the innermost program span open at the gap's middle (what the host
        was doing), or "outside the program's spans"."""
        gaps, end = [], None
        for _, s, d in self.ops:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = s + d if end is None else max(end, s + d)
        gaps.sort(reverse=True)
        self.gaps = []
        for length, g0, g1 in gaps[:k]:
            mid = 0.5 * (g0 + g1) / 1e6 + self.to_mono
            inner = [sp for sp in spans if sp["t0"] <= mid <= sp["t1"]]
            name = max(inner, key=lambda sp: sp["t0"])["name"] if inner else \
                "outside the program's spans"
            self.gaps.append([name, length / 1e6])


def spread(values: Sequence[float]) -> float:
    """Interquartile range as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


class Tracer:
    """The traced run's instruments: the program's telemetry (spans and
    counters, drained after every timed call so its ring never wraps) over
    the whole window, and ``torch.profiler`` (device activity only, which
    adds little to the host's work) over its first ``profile_seconds``.
    Span metrics read the spans outside the profiled part; the device
    metrics read the profiled part."""

    def __init__(self, profile_seconds: float, device_kind: str):
        self.profile_seconds = profile_seconds
        self.cuda = device_kind == "cuda"
        self.spans: List[Dict[str, Any]] = []
        self.counters: Dict[str, int] = {}
        self.prof = None
        self.device_trace: Optional[DeviceTrace] = None
        self.prof_t = (0.0, 0.0)  # telemetry-clock (monotonic) bounds of the profile

    def _drain(self) -> None:
        from repro_torch.core import telemetry

        tel = telemetry.get()
        self.spans.extend(e for e in tel.trace_events() if e.get("kind") == "span")
        for k, v in tel.metrics()["counters"].items():
            self.counters[k] = self.counters.get(k, 0) + v
        tel.reset()

    def start(self) -> None:
        import time

        import torch
        from repro_torch.core import telemetry

        telemetry.get().reset()
        telemetry.set_enabled(True)
        if self.cuda and self.profile_seconds > 0:
            self.prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.t0 = time.perf_counter()
        self.prof_t = (time.monotonic(), time.monotonic())

    def _stop_profile(self) -> None:
        import time

        import torch

        torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        self.prof_t = (self.prof_t[0], time.monotonic())
        self.prof.__exit__(None, None, None)
        self.device_trace = DeviceTrace.from_profile(self.prof, wall)
        self.prof = None
        self.device_trace.name_gaps(self.spans_in_profile())

    def after_call(self) -> None:
        import time

        self._drain()
        if self.prof is not None and time.perf_counter() - self.t0 >= self.profile_seconds:
            self._stop_profile()

    def stop(self) -> None:
        from repro_torch.core import telemetry

        if self.prof is not None:
            self._stop_profile()
        self._drain()
        telemetry.set_enabled(False)

    def spans_in_profile(self) -> List[Dict[str, Any]]:
        lo, hi = self.prof_t
        return [s for s in self.spans if lo <= s["t0"] and s["t1"] <= hi]

    def spans_outside_profile(self) -> List[Dict[str, Any]]:
        lo, hi = self.prof_t
        return [s for s in self.spans if s["t0"] >= hi or s["t1"] <= lo]
