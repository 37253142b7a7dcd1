"""Run one cell of the port's benchmark once.

    python3 amt_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's files are found by name (see ``harness.py``). The run sets up the
cell (kernels built or loaded from ``build/repro_torch/``, weights or warm-up
made from ``--seed``), measures for ``--seconds``, reads its metrics
(end-to-end with ``--trace 0``, per-layer with ``--trace 1``), checks the
window's results against the plain reference, and prints the numbers
compared, each beside its limit, as the last lines of standard error and a
JSON result as the last line of standard output. It needs the CUDA cards the
cell asks for and the port (``src/repro_torch``) beside it; it loads neither
JAX nor the JAX package.
"""

from __future__ import annotations

import os
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_ROOT))
sys.path.insert(0, str(_ROOT / "src"))

from amt_bench import harness  # noqa: E402


def fail(msg: str, code: int = 2) -> None:
    print(f"amt_bench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides=None, conf_overrides=None, t_start: float = None, dump=None):
    """Set up, measure and check one run of ``name``. Returns the result
    object and the checks (name, value, limit, count). ``device="cpu"`` and
    the overrides (merged into the workload and configuration files) are
    for the CPU tests."""
    import torch

    t_import = time.perf_counter() - (T_START if t_start is None else t_start)
    bench = harness.manifest()
    entry, workload, conf = harness.cell_files(name, bench)
    workload, conf = harness.merged(workload, overrides), harness.merged(conf, conf_overrides)
    runner = harness.load_module("runners", workload["runner"])
    dev = torch.device(device)
    cell = runner.Cell(conf, workload, seed, dev)
    cell.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - (T_START if t_start is None else t_start)

    tracer = None
    if trace:
        tracer = harness.Tracer(workload["profile_seconds"], dev.type)
    gc_before = [g["collections"] for g in gc.get_stats()]
    record = cell.window(seconds, tracer)
    if dump:
        gc_window = [g["collections"] - b for g, b in zip(gc.get_stats(), gc_before)]
        with open(dump, "w", encoding="utf-8") as fh:
            json.dump({**{k: v for k, v in record.items() if k != "call_ms"},
                       "gc_collections": gc_window}, fh)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        # reserved, not allocated: a captured CUDA graph's activations live
        # in its private pool, which the allocator counts as reserved only
        peak = torch.cuda.max_memory_reserved()
    else:
        peak = 0
    record.update(setup_s=setup_s, tracer=tracer, conf=conf, workload=workload,
                  device_name=torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                  memory_peak_bytes=peak)
    metrics = {}
    for m in harness.metrics_of(bench, name, trace):
        value = harness.load_module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": record["device_name"], "count": entry["chips"],
              "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": record["attempted"],
              "failed": record["failed"], "metrics": metrics, "device": device}
    if trace and tracer.device_trace is not None:
        dt = tracer.device_trace
        device.update(busy_s=dt.busy_s(), window_s=dt.window_s)
        result["breakdown"] = {"device_ops": dt.top_ops(), "idle_gaps": dt.gaps}

    t_check = time.perf_counter()
    checks = cell.check()
    check_s = time.perf_counter() - t_check
    correct = record["failed"] == 0 and all(v <= lim for _, v, lim, _ in checks)
    result["correct"] = bool(correct)
    result["setup_parts"] = {"import_s": t_import, **cell.setup_parts}
    result["check_s"] = check_s
    result["checks"] = {c[0]: {"value": c[1], "limit": c[2]} for c in checks}
    # last, once the metric readers and the reference have run too
    found = harness.loaded_forbidden()
    if found:
        fail(f"modules of the JAX stack or package are loaded: {found}", 4)
    return result, checks


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dump", default=None,
                    help="also write the window's per-call or per-step record (JSON) here")
    args = ap.parse_args()

    if not (_ROOT / "src" / "repro_torch").is_dir():
        fail(f"the port is not in this checkout ({_ROOT / 'src' / 'repro_torch'})")
    try:
        import torch
    except ImportError as exc:
        fail(f"torch is missing: {exc}")
    bench = harness.manifest()
    entry, _, _ = harness.cell_files(args.workload, bench)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the benchmark runs on NVIDIA cards", 3)
    if torch.cuda.device_count() < entry["chips"]:
        fail(f"the cell needs {entry['chips']} cards, {torch.cuda.device_count()} found", 3)
    os.environ.setdefault("USE_FLAX", "0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              dump=args.dump)
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in result["setup_parts"].items()),
          file=sys.stderr)
    for cname, value, limit, count in checks:
        extra = f" over {count} decisions" if count is not None else ""
        print(f"check {cname} {value!r} limit {limit!r}{extra} "
              f"{'ok' if value <= limit else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
