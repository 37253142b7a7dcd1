"""Time the Matérn-5/2 routes of the GP factor layer on one NVIDIA card:
this tree's against an earlier tree's, in turns, in one process:

    python3 tools/matern52_variants.py [--parent DIR]

Run from a checkout's root on a machine with the card, ``nvcc`` and
CUDA-enabled torch (no JAX needed). DIR is the ``src/repro_torch`` package
of an earlier tree, for example

    git archive c00f7f8 src/repro_torch | tar -x -C build/matern52_parent
    python3 tools/matern52_variants.py --parent build/matern52_parent/src/repro_torch

The tool copies DIR to ``build/matern52_variants/parent/`` as the package
``repro_torch_parent`` (its imports renamed), so both trees run side by
side; each builds its own ``matern52.cu``. At S = 10 GPHP samples, d = 6,
R = 3 pending points and the row buckets 8, 16, 32 and 64 at the jobs' live
counts (5, 13, 29, 60), it prints for each route:

* (a) ``kernel_ms``: the CUDA-event time of each launch, the host's work
  hidden behind a device sleep — the cross rows of the pending set (this
  tree: one launch; the parent: one launch a row, three), the factorize
  operand (this tree) or the gram under it (the parent), and the empty
  kernel (the launch floor);
* (b) the engine-level call, from the engine's float64 tensors to the
  float64 rows or operand (``gram_rows`` against three ``gram_cross``;
  ``gp._masked_kernel`` on the kernel backend), host clock around
  synchronized work;
* (c) the whole pending fold as the engine makes it (the constant liar's
  three fantasy appends, each with ``refresh_alpha``, the pending rows
  uploaded as the engine uploads them), host clock around synchronized
  work;
* (d) end to end: ``chip_smoke.py``'s 64-trial main-path job (its space
  and seeded objective, the paper's engine, 4 slots, the constant liar,
  both backends "kernel") with each tree, in turns: the GP decisions'
  p50 and p80, the ``suggest.factorize`` and ``suggest.acq_opt`` medians
  and the cross-row and factorize launches per GP decision.

Routes of the two trees run in turns (parent, this, this, parent) and each
time is a median over many calls. The folded factors, L⁻¹ and α of the two
trees, and their operands, are compared (max |Δ|). Prints the card's name
and power limit first. Without ``--parent`` it times this tree alone.
"""

from __future__ import annotations

import argparse
import importlib
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "build" / "matern52_variants"
S, D, R = 10, 6, 3
CASES = ((5, 8), (13, 16), (29, 32), (60, 64))  # (live rows, bucket)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        sys.exit(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def load_parent(src: Path):
    """Import the package at ``src`` as ``repro_torch_parent``."""
    dst = OUT / "parent" / "repro_torch_parent"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__"))
    for f in dst.rglob("*.py"):
        f.write_text(re.sub(r"\brepro_torch\b", "repro_torch_parent", f.read_text()))
    sys.path.insert(0, str(OUT / "parent"))
    return importlib.import_module("repro_torch_parent")


def build(builders, names=("matern52", "acq_score", "slice_chain")) -> None:
    """Build each tree's libraries of the main path where its wrappers load
    them (one nvcc each, all started together); the others are not needed."""
    procs = []
    for b in builders:
        for name in names:
            lib = b._lib_path(name)
            if lib.is_file():
                continue
            lib.parent.mkdir(parents=True, exist_ok=True)
            cmd = [b._nvcc(), *b._FLAGS, "-I", str(b._CSRC), "-o", str(lib),
                   str(b._CSRC / b.SOURCES[name])]
            procs.append((b, name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True)))
    for b, name, proc in procs:
        log, _ = proc.communicate()
        (b.build_dir() / f"lib{name}.log").write_text(log)
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {b._CSRC / b.SOURCES[name]}:\n{log}")


def main_path_job(torch, core, np, math):
    """chip_smoke.py's 64-trial main-path job with one tree's package
    ``core``: (decision p50, p80, factorize median, acq_opt median, cross
    launches and factorize launches per GP decision, best objective)."""
    pkg = core.__name__.split(".")[0]
    kernels, telemetry, slice_mod, acq_mod, sched = (
        importlib.import_module(f"{pkg}.{mod}") for mod in (
            "kernels", "core.telemetry", "core.gp.slice_sampler", "core.optimize_acq",
            "core.scheduler"))
    space = core.SearchSpace([
        core.Continuous("eta", 1e-3, 1.0, scaling="log"),
        core.Integer("max_depth", 1, 10),
        core.Continuous("min_child_weight", 1e-2, 1e2, scaling="log"),
        core.Continuous("subsample", 0.5, 1.0),
        core.Continuous("colsample_bytree", 0.3, 1.0),
        core.Continuous("alpha", 1e-4, 10.0, scaling="log"),
    ])
    orng = np.random.default_rng(2021)  # invariant: fresh-rng -- chip_smoke.py's seeded objective; nothing is checkpointed or replayed
    opt = orng.random(6)
    weights = 0.5 + orng.random(6)

    def objective(cfg):
        u = space.encode(cfg)
        floor = 0.1 + float(np.sum(weights * (u - opt) ** 2))
        floor += 0.01 * math.sin(7.0 * float(np.sum(u)))
        t = np.arange(1, 11)
        return floor + 0.5 * np.exp(-0.3 * t), 1.0 + 0.2 * cfg["max_depth"]

    cfg = core.BOConfig(
        slice_config=slice_mod.PAPER_CONFIG,
        acq=acq_mod.AcqOptConfig(num_anchors=1024, num_refine=8, refine_steps=25),
        refit_every=1, backend="kernel", fit_backend="kernel", pending_strategy="liar")
    telemetry.get().reset()
    telemetry.set_enabled(True)
    kernels.reset_launch_counts()
    tuner = core.Tuner(space, objective, core.BOSuggester(space, cfg, seed=0),
                       sched.SimBackend(), core.TuningJobConfig(max_trials=64, max_parallel=4))
    res = tuner.run()
    torch.cuda.synchronize()
    telemetry.set_enabled(False)
    by_id = {ev["span_id"]: ev for ev in telemetry.get().trace_events()
             if ev.get("kind") == "span"}

    def decision_of(ev):
        up = by_id.get(ev["parent_id"])
        while up is not None and up["name"] != "suggest.decide":
            up = by_id.get(up["parent_id"])
        return None if up is None else up["span_id"]

    gp_ids = {decision_of(ev) for ev in by_id.values()
              if ev["name"] == "suggest.posterior"} - {None}
    dec = sorted(by_id[i]["dur"] * 1e3 for i in gp_ids)

    def med(name):
        return statistics.median(ev["dur"] * 1e3 for ev in by_id.values() if ev["name"] == name)

    launches = kernels.LAUNCHES
    factorize = launches.get("matern52_operand", 0) + launches["matern52_gram"]
    return (statistics.median(dec), dec[min(len(dec) - 1, math.ceil(0.8 * len(dec)) - 1)],
            med("suggest.factorize"), med("suggest.acq_opt"),
            launches["matern52_cross"] / len(dec), factorize / len(dec), res.best_objective)


def event_ms(torch, fn, reps: int = 50) -> float:
    """Median CUDA-event time of one call, the host hidden behind a sleep."""
    for _ in range(3):
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


def host_ms(torch, fn, reps: int = 50) -> float:
    """Median host-clock time of one call and a synchronize."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def in_turns(torch, timer, this_fn, parent_fn):
    """(this, parent) times: parent, this, this, parent, each a median."""
    if parent_fn is None:
        return timer(torch, this_fn), None
    p1, t1, t2, p2 = (timer(torch, f) for f in (parent_fn, this_fn, this_fn, parent_fn))
    return (t1 + t2) / 2, (p1 + p2) / 2


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="the src/repro_torch directory of an earlier tree")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA card visible: this tool times the kernels on the card")
    print(nvidia_smi("name,power.limit"), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.core import BOConfig, BOSuggester, Continuous, SearchSpace
    from repro_torch.core.gp import gp as G
    from repro_torch.core.gp import params as P
    from repro_torch.core.gp.kernels import append_rows, gram_rows
    from repro_torch.core.history import bucket_size
    from repro_torch.kernels import _build
    from repro_torch.kernels.matern52.kernel import (
        empty_kernel,
        matern52_cross_kernel,
        matern52_gram_kernel,
        matern52_operand_kernel,
    )
    from repro_torch.kernels.matern52.ops import packed_params

    builders = [_build]
    par = None
    if args.parent is not None:
        par = load_parent(args.parent.resolve())
        builders.append(importlib.import_module("repro_torch_parent.kernels._build"))
        pcore = importlib.import_module("repro_torch_parent.core")
        PG = importlib.import_module("repro_torch_parent.core.gp.gp")
        PP = importlib.import_module("repro_torch_parent.core.gp.params")
        PK = importlib.import_module("repro_torch_parent.core.gp.kernels")
        pkern = importlib.import_module("repro_torch_parent.kernels.matern52.kernel")
        pops = importlib.import_module("repro_torch_parent.kernels.matern52.ops")
    t0 = time.perf_counter()
    build(builders)
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in _build.ptxas_report("matern52").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    dev = torch.device("cuda")
    rng = np.random.default_rng(20)  # invariant: fresh-rng -- a one-shot probe's seeded inputs; nothing is checkpointed or replayed
    space = SearchSpace([Continuous(f"x{i}", 0.0, 1.0) for i in range(D)])
    this_engine = BOSuggester(space, BOConfig(fit_backend="kernel", pending_strategy="liar"),
                              seed=0, device=dev)
    if par is not None:
        pspace = pcore.SearchSpace([pcore.Continuous(f"x{i}", 0.0, 1.0) for i in range(D)])
        par_engine = pcore.BOSuggester(
            pspace, pcore.BOConfig(fit_backend="kernel", pending_strategy="liar"),
            seed=0, device=dev)

    floor = event_ms(torch, empty_kernel)
    print(f"launch floor (empty kernel): {floor:.5f} ms", flush=True)
    base = P.default_params(D).pack().numpy()
    table_np = np.stack([base + 0.1 * rng.standard_normal(3 * D + 2) for _ in range(S)])
    table = torch.as_tensor(table_np).to(dev)
    params = P.GPHyperParams.unpack(table, D)
    packed32, _ = packed_params(params, True, torch.float32)
    if par is not None:
        pparams = PP.GPHyperParams.unpack(table.clone(), D)
        ppacked, _ = pops.packed_params(pparams, True, torch.float32)

    for live, n in CASES:
        x_np = np.zeros((n, D))
        x_np[:live] = rng.random((live, D))
        y_np = np.zeros(n)
        y_np[:live] = rng.standard_normal(live)
        pend = rng.random((R, D))
        xt = torch.as_tensor(x_np).to(dev)
        yt = torch.as_tensor(y_np).to(dev)
        mt = torch.as_tensor(np.arange(n) < live).to(dev)
        xb = torch.as_tensor(pend).to(dev)
        size = max(n, bucket_size(live + R))
        head = f"n={n} live={live} S={S} d={D} R={R}"

        # (a) kernel_ms of each launch
        k_rows = event_ms(torch, lambda: matern52_cross_kernel(xb, xt, table, live, size))
        k_op = event_ms(torch, lambda: matern52_operand_kernel(xt, table, mt, G._JITTER))
        # each cross row against the gram's own entries for the same pair
        # of rows (the bucket after the appends before it)
        z = append_rows(xb, xt, live, size).float()
        rows = matern52_cross_kernel(xb, xt, table, live, size)
        g = matern52_gram_kernel(z, z, *packed32).double()
        gap = max(float((rows[:, r, :live + r] - g[:, live + r, :live + r]).abs().max())
                  for r in range(R))
        line = (f"{head} (a) kernel_ms: rows (one launch, {R} rows) {k_rows:.5f}, "
                f"operand {k_op:.5f}; rows against the gram's entries max |Δ| {gap:.3e}")
        if par is not None:
            x32 = xt.float()
            xn32 = xb.float()
            k_one = event_ms(torch, lambda: pkern.matern52_cross_kernel(xn32[0], x32, *ppacked))
            k_three = event_ms(torch, lambda: [pkern.matern52_cross_kernel(xn32[r], x32, *ppacked)
                                               for r in range(R)])
            k_gram = event_ms(torch, lambda: pkern.matern52_gram_kernel(x32, x32, *ppacked))
            pg = pkern.matern52_gram_kernel(z, z, *ppacked).double()
            pgap = max(float((pkern.matern52_cross_kernel(z[live + r], z, *ppacked).double()
                              - pg[:, live + r])[:, :live + r].abs().max()) for r in range(R))
            line += (f"; parent: cross (one row) {k_one:.5f}, {R} rows (three launches) "
                     f"{k_three:.5f}, gram {k_gram:.5f}; its cross against its gram's "
                     f"entries max |Δ| {pgap:.3e}")
        print(line, flush=True)

        # (b) the engine-level call
        this_rows = lambda: gram_rows(xb, xt, live, size, params, backend="kernel")  # noqa: E731
        this_op = lambda: G._masked_kernel(xt, params, mt, "kernel")  # noqa: E731
        par_rows = par_op = None
        if par is not None:
            def par_rows():
                xs = xt
                out = []
                for r in range(R):
                    idx = live + r
                    if idx >= xs.shape[0]:
                        xs = torch.nn.functional.pad(
                            xs, (0, 0, 0, bucket_size(idx + 1) - xs.shape[0]))
                    out.append(PK.gram_cross(xb[r], xs, pparams, backend="kernel"))
                return out

            par_op = lambda: PG._masked_kernel(xt, pparams, mt, "kernel")  # noqa: E731
        r_this, r_par = in_turns(torch, host_ms, this_rows, par_rows)
        o_this, o_par = in_turns(torch, host_ms, this_op, par_op)
        line = f"{head} (b) engine call ms: rows {r_this:.5f}, operand {o_this:.5f}"
        if par is not None:
            op_err = float((this_op() - par_op()).abs().max())
            line += (f"; parent: {R} gram_cross {r_par:.5f} ({r_this / r_par:.2f}x), "
                     f"masked gram {o_par:.5f} ({o_this / o_par:.2f}x); operands max |Δ| "
                     f"{op_err:.3e}")
        print(line, flush=True)

        # (c) the whole pending fold, as each engine makes it
        post = G.fit_posterior_batch(xt, yt, params, mt, backend="kernel", with_inverse=True)
        y0 = list(y_np[:live])

        def this_fold():
            work, y = post, y0
            pb_ = this_engine._tensor(pend)
            rows = this_engine._pending_rows(work, pb_, live)
            for r in range(R):
                work, y = this_engine._fantasy_append(work, y, pb_[r], rows[..., r, :])
            return work

        par_fold = None
        if par is not None:
            ppost = PG.fit_posterior_batch(xt, yt, pparams, mt, backend="kernel",
                                           with_inverse=True)

            def par_fold():
                work, y = ppost, y0
                for r in range(R):
                    work, y = par_engine._fantasy_append(work, y, pend[r])
                return work

        f_this, f_par = in_turns(torch, host_ms, this_fold, par_fold)
        line = f"{head} (c) pending fold ms: {f_this:.5f}"
        if par is not None:
            a, b = this_fold(), par_fold()
            errs = ", ".join(f"{k} {float((getattr(a, k) - getattr(b, k)).abs().max()):.3e}"
                             for k in ("chol", "chol_inv", "alpha"))
            line += (f"; parent {f_par:.5f} ({f_this / f_par:.2f}x); folded factors max |Δ| "
                     f"{errs}; factorized max |Δ| "
                     f"{float((post.chol - ppost.chol).abs().max()):.3e}")
        print(line, flush=True)

    # (d) the main path end to end, each tree in turns
    import math

    import repro_torch.core as this_core

    trees = [("this", this_core)] + ([("parent", pcore)] if par is not None else [])
    order = trees if par is None else [trees[1], trees[0], trees[0], trees[1]]
    for label, core in order:
        t0 = time.perf_counter()
        p50, p80, fact, acq, cross, fz, best = main_path_job(torch, core, np, math)
        print(f"(d) main path, {label} tree: 64 trials in {time.perf_counter() - t0:.1f} s; "
              f"GP decision p50 {p50:.2f} ms, p80 {p80:.2f} ms; suggest.factorize median "
              f"{fact:.3f} ms, suggest.acq_opt median {acq:.2f} ms; per GP decision "
              f"{cross:.1f} cross-row and {fz:.1f} factorize launches; best objective "
              f"{best:.6f}", flush=True)
    print(nvidia_smi("name,power.limit,clocks.sm,power.draw"), flush=True)


if __name__ == "__main__":
    main()
