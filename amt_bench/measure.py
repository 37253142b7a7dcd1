"""Run a cell several times, each run its own process as the check makes it,
and print each metric's spread: what a bound is set from.

    python3 amt_bench/measure.py --workload <cell> --seeds 1,2,3,4,5,6 --sets 2 \
        --seconds 30 [--trace 1] [--out runs.jsonl]

Each set runs every seed once, in order; the sets use the same seeds. A
spread is the interquartile range over the median (``statistics.quantiles``
with n=4), per metric and per set. A first run (a seed of neither set),
which may build the kernels, comes before the sets and is reported apart.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(_HERE.parent))

from amt_bench.harness import spread  # noqa: E402


def one_run(cell: str, seed: int, seconds: float, trace: int, dump: str = None) -> dict:
    t0 = time.perf_counter()
    cmd = [sys.executable, str(_HERE / "run.py"), "--workload", cell, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    proc = subprocess.run(cmd + (["--dump", dump] if dump else []),
                          capture_output=True, text=True, cwd=_HERE.parent)
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"seed": seed, "rc": proc.returncode, "wall_s": time.perf_counter() - t0,
            "result": result, "stderr_tail": proc.stderr[-1500:]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--dump-dir", default=None, help="each run's window record goes here")
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a", encoding="utf-8") if args.out else None
    first = one_run(args.workload, seeds[0] + 1_000_003, args.seconds, args.trace)
    res = first["result"] or {}
    print(json.dumps({"first": True, "rc": first["rc"], "wall_s": first["wall_s"],
                      "correct": res.get("correct"),
                      "metrics": {m: v["value"] for m, v in res.get("metrics", {}).items()}}),
          flush=True)
    runs = []
    for k in range(args.sets):
        for seed in seeds:
            dump = (f"{args.dump_dir}/{args.workload}_{k}_{seed}.json" if args.dump_dir
                    else None)
            r = one_run(args.workload, seed, args.seconds, args.trace, dump)
            r["set"] = k
            runs.append(r)
            res = r["result"] or {}
            summary = {m: v["value"] for m, v in res.get("metrics", {}).items()}
            print(json.dumps({"set": k, "seed": seed, "rc": r["rc"], "wall_s": r["wall_s"],
                              "correct": res.get("correct"), "attempted": res.get("attempted"),
                              "metrics": summary, "checks": res.get("checks")}), flush=True)
            if r["rc"] != 0 or not res.get("correct"):
                print(r["stderr_tail"], file=sys.stderr, flush=True)
            if out:
                out.write(json.dumps(r) + "\n")
                out.flush()
    ok = [r for r in runs if r["result"]]
    names = sorted({m for r in ok for m in r["result"]["metrics"]})
    for m in names:
        for k in range(args.sets):
            vals = [r["result"]["metrics"][m]["value"] for r in ok
                    if r["set"] == k and m in r["result"]["metrics"]]
            if len(vals) >= 2:
                print(f"spread {m} set {k}: {spread(vals):.5f} median "
                      f"{statistics.median(vals)!r} n={len(vals)}", flush=True)


if __name__ == "__main__":
    main()
