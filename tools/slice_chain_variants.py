"""Take the slice-chain CUDA kernel apart on one NVIDIA card: what one
log-density evaluation spends its time on, and what the rounds of the
cluster schedule save against one evaluation after another:

    python3 tools/slice_chain_variants.py [--parent DIR]

Run from a checkout's root on a machine with the card, ``nvcc`` and
CUDA-enabled torch (no JAX needed). Each variant is
``src/repro_torch/kernels/csrc/slice_chain.cu`` built by its own ``nvcc``
(all started together) into ``build/slice_chain_variants/``:

* ``kernel`` — the source as it is;
* ``stamps`` — built with ``-DSLICE_CHAIN_STAMPS``: thread 0 of each block
  sums ``clock64()`` cycles by stage of an evaluation (box test and prior,
  parameter packing, warped rows, gram, and per panel of the factor its
  top block, its values and its update, then logdet and quadratic form) and
  of a round (plan, point, exchange of the values and the cluster barrier);
* ``reeval`` — built with ``-DSLICE_CHAIN_REEVAL_G0``: g(0) evaluated at
  every update, as the sequential chain does, instead of carried;
* ``inline`` — the schedule's functions (run by thread 0) inlined into the
  kernel instead of called;
* ``depth1``, ``depth3`` — a round takes 1 or 3 stepping-out points from
  each open side instead of 2;
* ``no_unroll`` — the panel update's row loop not unrolled (the kernel
  unrolls it by 4);
* ``unroll_gram`` — the gram's column loop unrolled by 4.

The chain is the paper's (300 updates, up to 8 step-outs a side, 32 shrinks)
on seeded data: random inputs in the unit cube and a standardized smooth
target, a few live rows under each row bucket 8–256, the engine's start and
bounds, both gram types. For each case the tool prints the cluster width W
the wrapper takes, and for each variant at W (the kernel, ``stamps`` and
``reeval`` also at W = 1, one evaluation a round: the sequential chain,
and the kernel at W = 8) the evaluations made, the rounds and the median
time over a few launches (CUDA events, host work
hidden behind a device sleep), in turns. Every run must give the wrapper's
kept samples, counts and trace bit for bit: the width, the stamps and the
re-evaluated g(0) change how the chain is run, not what it computes. The
stamps are printed as cycles and µs an evaluation (µs at the card's maximum
SM clock). With ``--parent DIR`` (the ``csrc/`` directory of an earlier
tree, whose ``slice_chain_f32/f64`` take no width and write four counts),
its kernel runs the same cases in turns with the current one (parent,
kernel, kernel, parent). Prints the card's name and power limit first.

Exits non-zero if a run differs from the wrapper's.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "slice_chain_variants"
# name -> (nvcc flags, edits of the source's text)
VARIANTS = {
    "kernel": ([], []),
    "stamps": (["-DSLICE_CHAIN_STAMPS"], []),
    "reeval": (["-DSLICE_CHAIN_REEVAL_G0"], []),
    "inline": ([], [("__device__ __noinline__", "__device__ __forceinline__")]),
    "depth1": ([], [("constexpr int kDepth = 2;", "constexpr int kDepth = 1;")]),
    "depth3": ([], [("constexpr int kDepth = 2;", "constexpr int kDepth = 3;")]),
    "no_unroll": ([], [("#pragma unroll 4  // independent entries in flight", "//")]),
    "unroll_gram": ([], [("    for (int j = tid % kGrid; j <= jmax; j += kGrid) {",
                          "#pragma unroll 4\n    for (int j = tid % kGrid; j <= jmax; j += kGrid) {")]),
}
# variants timed at the wrapper's width only, beside the kernel
EDITED = ("inline", "depth1", "depth3", "no_unroll", "unroll_gram")
CASES = ((5, 8), (13, 16), (29, 32), (60, 64), (124, 128), (250, 256))  # (live, n)
STAMPED = {8, 16, 32, 64}  # buckets whose evaluations are taken apart
STAGES = ("box+prior", "pack", "rows", "gram", "panel_top", "panel_values", "panel_update",
          "logdet+quad", "plan", "point", "exchange")
PANEL = 4  # pivots a panel (slice_chain.cu kPanel)
D_FEAT = 6


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        sys.exit(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def build(parent: Path | None) -> dict:
    """Build every variant (and the parent), all nvcc runs at once; returns
    name -> (library, ptxas lines)."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (flags, edits) in VARIANTS.items():
        text = (CSRC / "slice_chain.cu").read_text()
        for old, new in edits:
            if old not in text:
                sys.exit(f"variant {name}: {old!r} is not in slice_chain.cu")
            text = text.replace(old, new)
        (OUT / f"{name}.cu").write_text(text)
        jobs[name] = (OUT / f"{name}.cu", CSRC, flags)
    if parent is not None:
        jobs["parent"] = (parent / "slice_chain.cu", parent, [])
    procs = {}
    for name, (source, include, flags) in jobs.items():
        cmd = [_build._nvcc(), *_build._FLAGS, *flags, "-I", str(include), "-o",
               str(OUT / f"lib{name}.so"), str(source)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc {name} failed:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        width = [] if name == "parent" else [ctypes.c_int]
        for sfx in ("f32", "f64"):
            fn = getattr(lib, f"slice_chain_{sfx}")
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_double]
                           + width + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        if name == "stamps":
            lib.slice_chain_stamps.argtypes = [ctypes.c_void_p]
            lib.slice_chain_stamps.restype = ctypes.c_int
        lines = [ln.strip() for ln in log.splitlines()
                 if re.search(r"Used \d+ registers|spill stores", ln)]
        libs[name] = (lib, lines)
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="csrc/ directory of an earlier tree to time in turns")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("slice_chain_variants needs an NVIDIA card: torch.cuda.is_available() is false")
    from repro_torch.core import prng
    from repro_torch.core.gp import params as P
    from repro_torch.core.gp.slice_sampler import PAPER_CONFIG, chain_draws
    from repro_torch.kernels import _build
    from repro_torch.kernels.slice_chain.kernel import SMEM_ROWS, slice_chain_kernel
    from repro_torch.kernels.slice_chain.plain import pack_table

    print(nvidia_smi("name,power.limit"), flush=True)
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}; max SM clock {clock_hz / 1e6:.0f} MHz", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    libs = build(args.parent)
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, (_, lines) in libs.items():
        for ln in lines:
            print(f"  ptxas {name}: {ln}", flush=True)
    wrapper_lib = _build.library("slice_chain")

    cfg = PAPER_CONFIG
    d, dev = D_FEAT, torch.device("cuda")
    dim = P.GPHyperParams.packed_size(d)
    bounds = P.default_bounds(d)
    z0 = np.clip(P.default_params(d).pack().numpy(), bounds.lower + 1e-4, bounds.upper - 1e-4)
    rng = np.random.default_rng(19)  # invariant: fresh-rng -- a one-shot probe's seeded inputs; nothing is checkpointed or replayed
    K = cfg.num_kept
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def median_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(3_000_000)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    failed = []
    for live, n in CASES:
        x = np.zeros((n, d))
        x[:live] = rng.random((live, d))
        target = np.sin(3.0 * x[:live] @ rng.standard_normal(d)) + x[:live].sum(axis=1)
        y = np.zeros(n)
        y[:live] = (target - target.mean()) / target.std()
        xt, yt = torch.as_tensor(x).to(dev), torch.as_tensor(y).to(dev)
        mt = torch.as_tensor(np.arange(n) < live).to(dev)
        table = torch.as_tensor(pack_table(bounds, z0, chain_draws(prng.PRNGKey(n), dim, cfg))).to(dev)
        reps = 3 if n <= 64 else 1
        m = live
        for dt, gram in (("f32", torch.float32), ("f64", torch.float64)):
            label = f"n={n} live={live} {dt}"
            kept_w, counts_w, tr_w, sched = slice_chain_kernel(xt, yt, mt, table, cfg, gram,
                                                                trace=True, schedule=True)
            ne = int(counts_w[0])
            W = int(sched[2])
            tsize = 4 if dt == "f32" else 8
            sizes = (n, d, cfg.max_stepout, cfg.max_shrink, tsize)
            in_smem = n <= SMEM_ROWS and (wrapper_lib.slice_chain_smem_bytes(*sizes, 1)
                                          <= wrapper_lib.slice_chain_smem_limit(0))
            ws_doubles = wrapper_lib.slice_chain_ws_bytes(n, d, tsize) // 8

            def run(name, width, trace=False, parent=False):
                lib = libs[name][0]
                out = torch.empty(K * dim + 6, dtype=torch.float64, device=dev)
                rows = (torch.empty((cfg.num_samples * (1 + 2 * cfg.max_stepout + cfg.max_shrink), 2),
                                    dtype=torch.float64, device=dev) if trace else None)
                ws = (None if in_smem else
                      torch.empty(max(width, 1) * ws_doubles, dtype=torch.float64, device=dev))
                fn = getattr(lib, f"slice_chain_{dt}")
                wargs = () if parent else (width,)
                err = fn(xt.data_ptr(), yt.data_ptr(), mt.data_ptr(), table.data_ptr(),
                         out.data_ptr(), None if rows is None else rows.data_ptr(),
                         None if ws is None else ws.data_ptr(), n, d, cfg.num_samples,
                         cfg.burn_in, cfg.thin, K, cfg.max_stepout, cfg.max_shrink,
                         float(cfg.step_size), *wargs, stream())
                if err != 0:
                    sys.exit(f"{label} {name} W={width}: CUDA error {err}")
                return out, rows

            print(f"{label}: W = {W}; the chain's evaluations {ne}, NaN {int(counts_w[1])}, "
                  f"exhausted {int(counts_w[2])}, in the box {int(counts_w[3])}", flush=True)
            runs = ([("kernel", W), ("kernel", 1), ("kernel", 8), ("stamps", W), ("stamps", 1),
                     ("reeval", W), ("reeval", 1)] + [(name, W) for name in EDITED])
            for name, width in runs:
                out, rows = run(name, width, trace=True)
                torch.cuda.synchronize()
                same = (torch.equal(out[: K * dim].view(K, dim), kept_w)
                        and torch.equal(out[K * dim: K * dim + 4], counts_w)
                        and torch.equal(rows[:ne, 0], tr_w[:ne, 0])
                        and torch.equal(torch.nan_to_num(rows[:ne, 1]),
                                        torch.nan_to_num(tr_w[:ne, 1])))
                if not same:
                    failed.append(f"{label} {name} W={width}")
                if name == "stamps":
                    libs["stamps"][0].slice_chain_stamps(
                        (ctypes.c_ulonglong * (16 * (len(STAGES) + 1)))())  # zero them
                    run(name, width)
                    torch.cuda.synchronize()
                    buf = (ctypes.c_ulonglong * (16 * (len(STAGES) + 1)))()
                    libs["stamps"][0].slice_chain_stamps(buf)
                    st = np.array(buf, dtype=np.float64).reshape(16, len(STAGES) + 1)[:width]
                    if n in STAMPED:
                        made = st[:, -1].sum()
                        rounds = float(out[K * dim + 5])
                        per_eval = st[:, :8].sum(axis=0) / made
                        panels = math.ceil(m / PANEL)
                        us = lambda cyc: cyc / clock_hz * 1e6  # noqa: E731
                        print(f"  stamps W={width}: {made:.0f} evaluations in {rounds:.0f} rounds; "
                              f"an evaluation {per_eval.sum():.0f} cycles "
                              f"({us(per_eval.sum()):.3f} us): " + ", ".join(
                                  f"{STAGES[i]} {per_eval[i]:.0f}" for i in range(8))
                              + f"; a panel ({panels} an evaluation): top "
                              f"{per_eval[4] / panels:.0f}, values {per_eval[5] / panels:.0f}, "
                              f"update {per_eval[6] / panels:.0f} cycles", flush=True)
                        rd = st[0, 8:11] / rounds
                        print(f"  stamps W={width}, block 0, a round: " + ", ".join(
                            f"{STAGES[8 + i]} {rd[i]:.0f} cycles ({us(rd[i]):.3f} us)"
                            for i in range(3)), flush=True)
                print(f"  {name} W={width}: {'same' if same else 'DIFFERS'}; evaluations made "
                      f"{int(out[K * dim + 4])}, rounds {int(out[K * dim + 5])}", flush=True)
            order = ([("kernel", W), ("kernel", 1), ("kernel", 8), ("reeval", W), ("reeval", 1)]
                     + [(name, W) for name in EDITED])
            if args.parent is not None:
                order = [("parent", 1)] + order + order[::-1] + [("parent", 1)]
            else:
                order = order + order[::-1]
            times = {}
            for name, width in order:
                ms = median_ms(lambda: run(name, width, parent=name == "parent"), reps)
                times.setdefault((name, width), []).append(ms)
            print("  times (ms, each run in turns): " + "; ".join(
                f"{name}{'' if name == 'parent' else f' W={width}'} "
                + " / ".join(f"{t:.5f}" for t in ts) for (name, width), ts in times.items()),
                flush=True)
            if args.parent is not None:
                out, rows = run("parent", 1, trace=True, parent=True)
                torch.cuda.synchronize()
                same = (torch.equal(out[: K * dim].view(K, dim), kept_w)
                        and torch.equal(out[K * dim: K * dim + 4], counts_w))
                bits = torch.equal(torch.nan_to_num(rows[:ne]), torch.nan_to_num(tr_w[:ne]))
                print(f"  parent: kept samples and counts {'the same' if same else 'DIFFER'}; "
                      f"trace {'the same bit for bit' if bits else 'differs'}", flush=True)
    if failed:
        print(f"FAIL: runs differ from the wrapper's: {failed}", flush=True)
        sys.exit(1)
    print("every run gave the wrapper's kept samples, counts and trace", flush=True)


if __name__ == "__main__":
    main()
