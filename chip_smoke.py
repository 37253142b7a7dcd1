"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA card, ``nvcc`` and the
port's sources (``src/repro_torch``). It imports nothing of JAX and nothing
of the JAX package. Phases:

1. setup — the card's name and power limit, torch/CUDA versions, TF32 off,
   and the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together);
2. kernels — each kernel against its plain PyTorch version on the card, on
   the same inputs, at the main path's shapes and a sweep around them:
   max error against the stated tolerance, kernel and plain times (CUDA
   events, median), and the card's lower bound for the same work;
3. invariance — the same short job twice on the card, anchors scored by the
   fused kernel and by the torch composition; the trial tables must agree;
4. main path — a 64-trial tuning job at the paper's engine configuration
   (slice sampler 300/250/5, 1024 anchors, 8 refined for 25 Adam steps,
   refit after every observation) with all three kernels on, launch counts
   set to 0 just before and read just after.

Prints one line per case, then a JSON line of per-kernel numbers, then as
its last line ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result line, on any failure — including no visible card.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# Data-sheet peaks (NVIDIA H100 data sheet, dense, no sparsity), by part:
# HBM bytes/s; FP64 and FP32 outside the tensor cores; FP64 on the tensor
# cores ("f64_tc"), which a float64 matrix product can use.
PEAKS = {
    "SXM": {"hbm": 3.35e12, "f64": 34e12, "f64_tc": 67e12, "f32": 67e12},
    "PCIe": {"hbm": 2.0e12, "f64": 26e12, "f64_tc": 51e12, "f32": 51e12},
    "NVL": {"hbm": 3.9e12, "f64": 30e12, "f64_tc": 60e12, "f32": 60e12},
}

REPLACES = {
    "acq_score": "src/repro/kernels/acq_score/kernel.py:314",
    "matern52_gram": "src/repro/kernels/matern52/kernel.py:148",
    "matern52_cross": "src/repro/kernels/matern52/kernel.py:117",
}
SOURCES = {
    "acq_score": "src/repro_torch/kernels/csrc/acq_score.cu",
    "matern52_gram": "src/repro_torch/kernels/csrc/matern52.cu",
    "matern52_cross": "src/repro_torch/kernels/csrc/matern52.cu",
}

# Tolerances, kernel vs plain version on the same inputs, as max |Δ| over
# max(1, max |plain|). float64: both sides are exact to ~1e-14; 1e-9 leaves
# room for summation order and FMA contraction. float32 gram/cross: the
# reference's own Pallas tolerance (tests/test_kernels.py). float32
# acq_score: σ² = amp² − ‖L⁻¹K*ᵀ‖² cancels near the data, where float32
# leaves ~1e-4·amp² of σ², so EI may move by up to ~1e-2 there.
TOL = {("acq_score", "f64"): 1e-9, ("acq_score", "f32"): 2e-2,
       ("matern52_gram", "f32"): 2e-5, ("matern52_cross", "f32"): 2e-5}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def part_of(name: str) -> str:
    if "PCIe" in name:
        return "PCIe"
    if "NVL" in name:
        return "NVL"
    return "SXM"


def time_ms(torch, fn, reps: int = 20, warmup: int = 3, hide_host: bool = True) -> float:
    """Median CUDA-event time of one call. With ``hide_host`` a ~1.5 ms
    device-side sleep is queued before the start event, so the host's
    Python and launch overhead overlaps the sleep and the events bracket
    device work only; without it the time is that of the call as the
    engine makes it, host overhead included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hide_host:
            torch.cuda._sleep(3_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: dict, peaks) -> tuple:
    """Least time for the work: the larger of bytes over the HBM rate and
    the operations, each over the peak of the units that can run them
    (``flops`` maps a PEAKS key to a FLOP count)."""
    t_bytes = nbytes / peaks["hbm"] * 1e3
    t_ops = sum(f / peaks[unit] for unit, f in flops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> None:
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        fail(f"numpy/torch missing: {exc}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    try:
        from repro_torch import kernels as K
        from repro_torch.kernels import _build
    except ImportError as exc:
        fail(f"cannot import the port (run from a checkout's root): {exc}")

    # ------------------------------------------------------------ 1. setup
    card = card_line()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    peaks = PEAKS[part_of(name)]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {name} "
          f"peaks {part_of(name)} {peaks}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {built or 'cached'} in {time.perf_counter() - t0:.2f} s "
          f"-> {_build.build_dir()}", flush=True)
    for lib in _build.SOURCES:
        for line in _build.ptxas_report(lib).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {lib}: {line.strip()}", flush=True)

    from repro_torch.core.gp import gp as G
    from repro_torch.core.gp import params as P
    from repro_torch.kernels.acq_score.kernel import acq_score_kernel
    from repro_torch.kernels.acq_score.ops import pack_inputs
    from repro_torch.kernels.acq_score.plain import acq_score_plain
    from repro_torch.kernels.matern52.kernel import (
        matern52_cross_kernel,
        matern52_gram_kernel,
    )
    from repro_torch.kernels.matern52.ops import packed_params
    from repro_torch.kernels.matern52.plain import (
        matern52_cross_plain,
        matern52_gram_plain,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def posterior(n: int, d: int, S: int):
        x = torch.as_tensor(rng.random((n, d))).to(dev)
        y = torch.as_tensor(rng.standard_normal(n)).to(dev)
        base = P.default_params(d).pack().numpy()
        packed = np.stack([base + 0.1 * rng.standard_normal(3 * d + 2)
                           for _ in range(S)])
        params = P.GPHyperParams.unpack(torch.as_tensor(packed).to(dev), d)
        mask = torch.ones(n, dtype=torch.bool, device=dev)
        return G.fit_posterior_batch(x, y, params, mask, with_inverse=True)

    results = {}  # kernel name -> numbers at the main path's shape
    # -------------------------------------------------------------- 2. kernels

    def check(kname, dt, label, kfn, pfn, nbytes, flops, main_shape):
        got = kfn()
        torch.cuda.synchronize()
        want = pfn()
        torch.cuda.synchronize()
        if got.shape != want.shape:
            fail(f"{kname} {label}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
        if not torch.isfinite(got).all():
            fail(f"{kname} {label}: non-finite kernel output")
        err = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        tol = TOL[(kname, dt)]
        k_ms = time_ms(torch, kfn)
        p_ms = time_ms(torch, pfn)
        call_ms = time_ms(torch, kfn, hide_host=False)
        b_ms, b_by = bound_ms(nbytes, flops, peaks)
        ok = err <= tol * scale
        print(f"{kname} {dt} {label}: max_abs_err {err:.3e} (tol {tol:.0e} x {scale:.3g}) "
              f"kernel_ms {k_ms:.5f} plain_ms {p_ms:.5f} bound_ms {b_ms:.6f} "
              f"({b_by}) call_ms {call_ms:.5f} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{kname} {dt} {label} disagrees with its plain version")
        if main_shape:
            results[kname] = {
                "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by,
            }

    # Work counts use the problem's own sizes (n train rows, d features),
    # not the padded widths the packed inputs carry.
    S, A = 10, 1024
    for d in (6, 20):
        for n in (64, 256, 1024):
            post = posterior(n, d, S)
            x_star = torch.as_tensor(rng.random((A, d))).to(dev)
            y_best = -1.0
            for dt, tdt in (("f64", torch.float64), ("f32", torch.float32)):
                args = pack_inputs(post, x_star, tdt)
                es = 8 if dt == "f64" else 4
                # anchors, train rows, the lower triangle of L⁻¹, α, mask,
                # four (S, d) parameter rows, amp², and the (S, A) output
                nbytes = es * (A * d + n * d + S * n * (n + 1) // 2 + S * n + n
                               + 4 * S * d + S + S * A)
                # L⁻¹K*ᵀ over the lower triangle: a float64 matrix product,
                # which the FP64 tensor cores can run; the warp (12 per
                # feature), distance (3 per feature), Matérn (~10), μ and
                # ‖v‖² (2 each) run outside them.
                tri = S * A * n * (n + 1)
                rest = S * A * n * (3 * d + 14) + S * (A + n) * d * 12
                flops = ({"f64_tc": tri, "f64": rest} if dt == "f64"
                         else {"f32": tri + rest})
                check(
                    "acq_score", dt, f"S={S} A={A} n={n} d={d}",
                    lambda: acq_score_kernel(*args, y_best, 2.0, "ei"),
                    lambda: acq_score_plain(*args, y_best, 2.0, "ei"),
                    nbytes, flops, main_shape=(dt == "f64" and n == 64 and d == 6),
                )
            del post

    d = 6
    for n in (64, 256, 1024):
        for s_gram in ((1, 10) if n == 64 else (1,)):
            x1 = torch.as_tensor(rng.random((n, d)), dtype=torch.float32).to(dev)
            base = P.default_params(d).pack().numpy()
            packed = np.stack([base + 0.1 * rng.standard_normal(3 * d + 2)
                               for _ in range(s_gram)])
            params = P.GPHyperParams.unpack(torch.as_tensor(packed).to(dev), d)
            pp, _ = packed_params(params, True, torch.float32)
            nbytes = 4 * (2 * n * d + 4 * s_gram * d + s_gram + s_gram * n * n)
            flops = s_gram * (n * n * (3 * d + 10) + 2 * n * d * 12)
            check(
                "matern52_gram", "f32", f"S={s_gram} n=m={n} d={d}",
                lambda: matern52_gram_kernel(x1, x1, *pp),
                lambda: matern52_gram_plain(x1, x1, *pp),
                nbytes, {"f32": flops}, main_shape=(n == 64 and s_gram == 1),
            )
    S = 10
    base = P.default_params(d).pack().numpy()
    packed = np.stack([base + 0.1 * rng.standard_normal(3 * d + 2) for _ in range(S)])
    params = P.GPHyperParams.unpack(torch.as_tensor(packed).to(dev), d)
    pp, _ = packed_params(params, True, torch.float32)
    for n in (64, 1024):
        xt = torch.as_tensor(rng.random((n, d)), dtype=torch.float32).to(dev)
        xn = torch.as_tensor(rng.random(d), dtype=torch.float32).to(dev)
        nbytes = 4 * (d + n * d + 4 * S * d + S + S * n)
        flops = S * (n * (3 * d + 10) + (n + 1) * d * 12)
        check(
            "matern52_cross", "f32", f"S={S} n={n} d={d}",
            lambda: matern52_cross_kernel(xn, xt, *pp),
            lambda: matern52_cross_plain(xn, xt, *pp),
            nbytes, {"f32": flops}, main_shape=(n == 64),
        )

    # ------------------------------------------------------- 3. invariance
    from repro_torch.core import (
        BOConfig, BOSuggester, Continuous, Integer, SearchSpace, Tuner,
        TuningJobConfig,
    )
    from repro_torch.core import telemetry
    from repro_torch.core.gp.slice_sampler import FAST_CONFIG, PAPER_CONFIG
    from repro_torch.core.optimize_acq import AcqOptConfig
    from repro_torch.core.scheduler import SimBackend

    space = SearchSpace([
        Continuous("eta", 1e-3, 1.0, scaling="log"),
        Integer("max_depth", 1, 10),
        Continuous("min_child_weight", 1e-2, 1e2, scaling="log"),
        Continuous("subsample", 0.5, 1.0),
        Continuous("colsample_bytree", 0.3, 1.0),
        Continuous("alpha", 1e-4, 10.0, scaling="log"),
    ])
    orng = np.random.default_rng(2021)
    opt = orng.random(6)  # the seeded optimum, in the encoded unit cube
    weights = 0.5 + orng.random(6)

    def objective(cfg):
        u = space.encode(cfg)
        floor = 0.1 + float(np.sum(weights * (u - opt) ** 2))
        floor += 0.01 * math.sin(7.0 * float(np.sum(u)))
        t = np.arange(1, 11)
        return floor + 0.5 * np.exp(-0.3 * t), 1.0 + 0.2 * cfg["max_depth"]

    def run_job(cfg, trials, parallel):
        sugg = BOSuggester(space, cfg, seed=0)
        tuner = Tuner(space, objective, sugg, SimBackend(),
                      TuningJobConfig(max_trials=trials, max_parallel=parallel))
        return tuner.run()

    t0 = time.perf_counter()
    tables = {}
    for backend in ("kernel", "torch"):
        cfg = BOConfig(slice_config=FAST_CONFIG, backend=backend, fit_backend="torch")
        res = run_job(cfg, 16, 2)
        tables[backend] = np.stack([space.encode(t.config) for t in res.trials])
    diff = float(np.abs(tables["kernel"] - tables["torch"]).max())
    print(f"invariance: 16 trials kernel vs torch scoring max |Δ| {diff:.3e} "
          f"(tol 1e-9) in {time.perf_counter() - t0:.1f} s", flush=True)
    if tables["kernel"].shape != (16, 6) or diff > 1e-9:
        fail("scoring backends disagree on the card")

    # ------------------------------------------------------- 4. main path
    cfg = BOConfig(
        slice_config=PAPER_CONFIG,
        acq=AcqOptConfig(num_anchors=1024, num_refine=8, refine_steps=25),
        refit_every=1, backend="kernel", fit_backend="kernel",
        # the constant liar folds the in-flight trials into the factor by
        # rank-1 appends (the cross-row kernel); with "exclude" and a refit
        # after every observation the engine would never append
        pending_strategy="liar",
    )
    telemetry.get().reset()
    telemetry.set_enabled(True)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_job(cfg, 64, 4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    telemetry.set_enabled(False)

    trials = res.trials
    if len(trials) != 64 or any(t.state != "COMPLETED" for t in trials):
        fail(f"main path: {len(trials)} trials, not 64 completed")
    enc = np.stack([space.encode(t.config) for t in trials])
    if len({tuple(np.round(e, 12)) for e in enc}) != 64:
        fail("main path: duplicate configurations")
    for t in trials:
        for p in space.parameters:
            v = t.config[p.name]
            if not (p.low <= v <= p.high * (1 + 1e-12)):
                fail(f"main path: {p.name}={v} outside [{p.low}, {p.high}]")
    if not math.isfinite(res.best_objective):
        fail("main path: best objective not finite")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"main path never launched {missing}")

    spans = {}
    by_id = {}
    for ev in telemetry.get().trace_events():
        if ev.get("kind") == "span":
            spans.setdefault(ev["name"], []).append(ev["dur"] * 1e3)
            by_id[ev["span_id"]] = ev
    decisions = len(spans.get("suggest.posterior", []))

    def med(name):
        v = spans.get(name)
        return f"{statistics.median(v):.2f} ms (n={len(v)})" if v else "none"

    # Decision latency is over GP decisions: the suggest.decide spans that
    # enclose a suggest.posterior span (cold-start decisions run no GP).
    gp_ids = set()
    for ev in by_id.values():
        if ev["name"] == "suggest.posterior":
            up = by_id.get(ev["parent_id"])
            while up is not None and up["name"] != "suggest.decide":
                up = by_id.get(up["parent_id"])
            if up is not None:
                gp_ids.add(up["span_id"])
    dec = sorted(by_id[i]["dur"] * 1e3 for i in gp_ids)
    print(f"main path: 64 trials in {wall:.1f} s, {decisions} GP decisions, "
          f"best objective {res.best_objective:.6f}", flush=True)
    if len(dec) != decisions:
        fail(f"main path: {len(dec)} GP decision spans for {decisions} posteriors")
    p80 = dec[min(len(dec) - 1, int(math.ceil(0.8 * len(dec))) - 1)]
    print(f"  decision latency (GP decisions, n={len(dec)}): p50 "
          f"{statistics.median(dec):.2f} ms, p80 {p80:.2f} ms, max "
          f"{dec[-1]:.2f} ms; {len(dec) / (sum(dec) / 1e3):.3f} GP decisions "
          f"per engine-busy second", flush=True)
    for span in ("suggest.decide", "suggest.gphp_fit", "suggest.factorize",
                 "suggest.rank1_append", "suggest.acq_opt", "suggest.dedup"):
        print(f"  span {span}: median {med(span)}", flush=True)
    for k, v in launches.items():
        print(f"  launches {k}: {v} ({v / max(decisions, 1):.1f} per GP decision)",
              flush=True)

    line = {"kernels": []}
    for kname in K.KERNEL_NAMES:
        r = results.get(kname)
        if r is None:
            fail(f"no kernel-phase numbers for {kname}")
        line["kernels"].append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        })
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
