"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA card, ``nvcc`` and the
port's sources (``src/repro_torch``). It imports nothing of JAX and nothing
of the JAX package. Phases:

1. setup — the card's name and power limit, torch/CUDA versions, TF32 off,
   and the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together);
2. kernels — each kernel against its plain PyTorch version on the card, on
   the same inputs, at the main path's shapes and a sweep around them
   (``acq_score_multi`` in all four modes; the scoring kernels also at the
   row buckets phases 4–5 reach, padded past the live rows as the engine
   pads them): max error against the stated tolerance, kernel and plain
   times (CUDA events, median), and the card's lower bound for the same
   work;
3. invariance — the same short job twice on the card, anchors scored by the
   fused kernel and by the torch composition; the trial tables must agree;
   then the same for a Pareto job with a constraint (``acq_score_multi``);
4. main path — a 64-trial single-metric tuning job at the paper's engine
   configuration (slice sampler 300/250/5, 1024 anchors, 8 refined for 25
   Adam steps, refit after every observation) with the single-metric
   kernels on;
5. multi-metric and cost-aware paths — three 24-trial jobs at the same
   engine configuration: constrained (objective + latency constraint),
   Pareto (two objectives + the constraint) and cost-aware EI per unit
   cost with a ``max_cost`` that stops the job early.

Launch counts are set to 0 just before each job of phases 4 and 5 and read
just after; each job must launch every kernel of its path, and score only
row buckets that phase 2 held against the plain version. Prints one line
per case and each phase's wall time, then a JSON line of per-kernel
numbers, then as its last line ``{"ok": true, "device": {...}}``. Exits
non-zero, with no result line, on any failure — including no visible card.
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
    "acq_score_multi": "src/repro/kernels/acq_score/kernel.py:254",
    "matern52_gram": "src/repro/kernels/matern52/kernel.py:148",
    "matern52_cross": "src/repro/kernels/matern52/kernel.py:117",
}
SOURCES = {
    "acq_score": "src/repro_torch/kernels/csrc/acq_score.cu",
    "acq_score_multi": "src/repro_torch/kernels/csrc/acq_score_multi.cu",
    "matern52_gram": "src/repro_torch/kernels/csrc/matern52.cu",
    "matern52_cross": "src/repro_torch/kernels/csrc/matern52.cu",
}
# The path whose launches the JSON line reports for each kernel.
PATH_OF = {"acq_score": "main", "acq_score_multi": "multi",
           "matern52_gram": "main", "matern52_cross": "main"}

# Tolerances, kernel vs plain version on the same inputs, as max |Δ| over
# max(1, max |plain|). float64: both sides are exact to ~1e-14; 1e-9 leaves
# room for summation order and FMA contraction. float32 gram/cross: the
# reference's own Pallas tolerance (tests/test_kernels.py). float32
# acq_score: σ² = amp² − ‖L⁻¹K*ᵀ‖² cancels near the data, where float32
# leaves ~1e-4·amp² of σ², so EI may move by up to ~1e-2 there.
# acq_score_multi: the same σ² and the same EI closed form, times a
# feasibility product in [0, 1] (constrained, pareto), a weighted sum of EIs
# with weights summing to 1 (rungs), or a discount applied to EI (cost) —
# the same 1e-9 / 2e-2, relative to max(1, max |plain|).
TOL = {("acq_score", "f64"): 1e-9, ("acq_score", "f32"): 2e-2,
       ("acq_score_multi", "f64"): 1e-9, ("acq_score_multi", "f32"): 2e-2,
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


def phase_done(label: str, t0: float) -> None:
    print(f"phase {label}: {time.perf_counter() - t0:.1f} s", flush=True)


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
    t_phase = time.perf_counter()
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
    phase_done("1 setup", t_phase)

    from repro_torch.core.gp import gp as G
    from repro_torch.core.gp import params as P
    from repro_torch.core.gp.multi import solve_head_alphas
    from repro_torch.core.optimize_acq import MultiMetricHead
    from repro_torch.kernels.acq_score.kernel import (
        acq_score_kernel,
        acq_score_multi_kernel,
    )
    from repro_torch.kernels.acq_score.ops import pack_inputs, pack_multi_inputs
    from repro_torch.kernels.acq_score.plain import (
        acq_score_multi_plain,
        acq_score_plain,
    )
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

    def posterior(n: int, d: int, S: int, live: int = 0):
        """An S-sample posterior over ``n`` rows laid out as the engine pads
        a shape bucket: the first ``live`` rows (all, by default) are data,
        the rest zero rows with mask 0, which the factor and L⁻¹ carry as an
        identity block."""
        live = live or n
        x_np = np.zeros((n, d))
        x_np[:live] = rng.random((live, d))
        y_np = np.zeros(n)
        y_np[:live] = rng.standard_normal(live)
        base = P.default_params(d).pack().numpy()
        packed = np.stack([base + 0.1 * rng.standard_normal(3 * d + 2)
                           for _ in range(S)])
        params = P.GPHyperParams.unpack(torch.as_tensor(packed).to(dev), d)
        mask = torch.as_tensor(np.arange(n) < live).to(dev)
        post = G.fit_posterior_batch(torch.as_tensor(x_np).to(dev),
                                     torch.as_tensor(y_np).to(dev), params, mask,
                                     with_inverse=True)
        return post, x_np[:live]

    results = {}  # kernel name -> numbers at the main path's shape
    # -------------------------------------------------------------- 2. kernels
    t_phase = time.perf_counter()

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

    # Work counts use the problem's own sizes (the live train rows, d
    # features), not the padded widths the packed inputs carry. Besides full
    # buckets, the cases (live, bucket) are padded the way the engine pads
    # the buckets the 64-trial main path reaches.
    S, A = 10, 1024
    cases = ([(d, n, n) for d in (6, 20) for n in (64, 256, 1024)]
             + [(6, 5, 8), (6, 13, 16), (6, 27, 32), (6, 50, 64)])
    # row buckets held against the plain version, per scoring kernel; each
    # job of phases 4–5 must stay within its kernel's
    checked_buckets = {"acq_score": {n for _, _, n in cases}}
    for d, live, n in cases:
        post, _ = posterior(n, d, S, live)
        x_star = torch.as_tensor(rng.random((A, d))).to(dev)
        y_best = -1.0
        pad = "" if live == n else f" live={live}"
        for dt, tdt in (("f64", torch.float64), ("f32", torch.float32)):
            args = pack_inputs(post, x_star, tdt)
            es = 8 if dt == "f64" else 4
            # anchors, train rows, the lower triangle of L⁻¹, α, mask,
            # four (S, d) parameter rows, amp², and the (S, A) output
            nl = live
            nbytes = es * (A * d + nl * d + S * nl * (nl + 1) // 2 + S * nl + nl
                           + 4 * S * d + S + S * A)
            # L⁻¹K*ᵀ over the lower triangle: a float64 matrix product,
            # which the FP64 tensor cores can run; the warp (12 per
            # feature), distance (3 per feature), Matérn (~10), μ and
            # ‖v‖² (2 each) run outside them.
            tri = S * A * nl * (nl + 1)
            rest = S * A * nl * (3 * d + 14) + S * (A + nl) * d * 12
            flops = ({"f64_tc": tri, "f64": rest} if dt == "f64"
                     else {"f32": tri + rest})
            check(
                "acq_score", dt, f"S={S} A={A} n={n}{pad} d={d}",
                lambda: acq_score_kernel(*args, y_best, 2.0, "ei"),
                lambda: acq_score_plain(*args, y_best, 2.0, "ei"),
                nbytes, flops,
                main_shape=(dt == "f64" and live == n == 64 and d == 6),
            )
        del post

    # acq_score_multi: every mode at the heads the multi-metric paths give
    # it (constrained 1 objective + 1 constraint; pareto 2 objectives + 1
    # constraint, W = 16 draws; rungs 4 heads; cost objective + log-cost),
    # at the shape buckets the 24-trial jobs of phase 5 reach — 8, 16 and
    # 32 rows, padded past the live rows as the engine pads them — and at
    # full buckets of 64 and 1024 rows. The main path's shape, whose numbers
    # the JSON line reports, is the largest bucket the jobs reach.
    d, n_draws = 6, 16
    MULTI = {"constrained": (2, 1), "pareto": (3, 1), "rungs": (4, 0), "cost": (2, 0)}
    multi_main = (23, 32)
    multi_cases = ((7, 8), (13, 16), multi_main, (64, 64), (1024, 1024))
    checked_buckets["acq_score_multi"] = {n for _, n in multi_cases}
    for live, n in multi_cases:
        post, x_np = posterior(n, d, S, live)
        x_star = torch.as_tensor(rng.random((A, d))).to(dev)
        # smooth standardized head targets over the live rows, as metrics
        # are; zero on the padded tail, as the engine's head block is
        yl = np.sin(3.0 * x_np @ rng.standard_normal((d, 4)) + rng.random(4)).T
        yl = (yl - yl.mean(axis=1, keepdims=True)) / yl.std(axis=1, keepdims=True)
        yh = np.zeros((4, n))
        yh[:, :live] = yl
        alphas = solve_head_alphas(post, torch.as_tensor(yh).to(dev))
        pad = "" if live == n else f" live={live}"
        for mode, (M, C) in MULTI.items():
            # the layouts the engine builds (see suggest.py's _decide_multi
            # and _decide_cost)
            t_std = np.full(C, 0.3)
            y_best, draws, ybw = 0.0, np.zeros((0, 1)), np.zeros(0)
            has_feasible = True
            if mode == "constrained":
                feas = yl[1] <= 0.3
                has_feasible = bool(feas.any())
                y_best = float(yl[0][feas].min()) if has_feasible else 0.0
            elif mode == "pareto":
                g = -np.log1p(-rng.random((n_draws, 2)))
                draws = g / g.sum(axis=1, keepdims=True)
                feas = yl[2] <= 0.3
                rows = feas if feas.any() else np.ones(live, bool)
                ybw = (yl[:2, rows].T @ draws.T).min(axis=0)
            elif mode == "rungs":
                r = np.array([1.0, 3.0, 9.0])
                draws = np.concatenate(([0.5], 0.5 * r / r.sum()))[None, :]
                ybw = yl.min(axis=1)
            else:
                y_best, draws, ybw = float(yl[0].min()), np.array([[1.0]]), np.zeros(1)
            head = MultiMetricHead(
                alphas=alphas[:, :M].contiguous(),
                t_std=torch.as_tensor(t_std).to(dev), y_best=y_best,
                has_feasible=has_feasible, weights=torch.as_tensor(draws).to(dev),
                y_best_w=torch.as_tensor(ybw).to(dev),
            )
            for dt, tdt in (("f64", torch.float64), ("f32", torch.float32)):
                args = pack_multi_inputs(post, head, x_star, mode, tdt)
                wr, wc = args[11].shape
                # per-anchor epilogue: Φ ≈ 12 and EI ≈ 20 operations
                epi = {"constrained": 20 + 12 * C, "pareto": wr * (4 * wc + 22) + 12 * C,
                       "rungs": 22 * M, "cost": 32}[mode]
                es = 8 if dt == "f64" else 4
                # acq_score's inputs with the (S, M, n) head block instead of
                # α, plus thresholds, weights and incumbents; live rows only
                nl = live
                nbytes = es * (A * d + nl * d + S * nl * (nl + 1) // 2 + S * M * nl
                               + nl + 4 * S * d + S + args[10].numel() + wr * wc
                               + args[12].numel() + S * A)
                tri = S * A * nl * (nl + 1)
                rest = (S * A * nl * (3 * d + 14) + S * (A + nl) * d * 12
                        + 2 * (M - 1) * S * A * nl + S * A * epi)
                flops = ({"f64_tc": tri, "f64": rest} if dt == "f64"
                         else {"f32": tri + rest})
                check(
                    "acq_score_multi", dt,
                    f"{mode} M={M} S={S} A={A} n={n}{pad} d={d}",
                    lambda: acq_score_multi_kernel(*args),
                    lambda: acq_score_multi_plain(*args),
                    nbytes, flops,
                    main_shape=(dt == "f64" and (live, n) == multi_main
                                and mode == "pareto"),
                )
        del post, alphas

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
    phase_done("2 kernels", t_phase)

    # ------------------------------------------------------- 3. invariance
    t_phase = time.perf_counter()
    from repro_torch.core import (
        BOConfig, BOSuggester, Continuous, Integer, MetricSet, MetricSpec,
        SearchSpace, Tuner, TuningJobConfig, pareto_mask,
    )
    from repro_torch.core import telemetry
    from repro_torch.core.gp.slice_sampler import FAST_CONFIG, PAPER_CONFIG
    from repro_torch.core.history import bucket_size
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

    def metric_objective(cfg):
        """The same seeded objective with named metrics: the final loss, a
        model size that grows with depth and column sampling (conflicting
        with the loss), and a latency that grows with depth and row
        sampling (the constraint)."""
        curve, cost = objective(cfg)
        u = space.encode(cfg)
        return curve, cost, {
            "loss": float(curve[-1]),
            "size": 0.2 + (u[1] - 0.1) ** 2 + 0.5 * (1.0 - u[4]) * u[2],
            "latency": 1.0 + 2.0 * u[1] + u[3] + 0.1 * math.cos(5.0 * u[0]),
        }

    LATENCY_MAX = 2.4
    CONSTRAINED = (MetricSpec("loss"),
                   MetricSpec("latency", objective=False, threshold=LATENCY_MAX))
    PARETO = (MetricSpec("loss"), MetricSpec("size"),
              MetricSpec("latency", objective=False, threshold=LATENCY_MAX))

    def run_job(cfg, trials, parallel, fn=objective, **job):
        sugg = BOSuggester(space, cfg, seed=0)
        tuner = Tuner(space, fn, sugg, SimBackend(),
                      TuningJobConfig(max_trials=trials, max_parallel=parallel, **job))
        return tuner, tuner.run()

    for label, fn, job in (("single-metric", objective, {}),
                           ("pareto + constraint", metric_objective,
                            {"metrics": PARETO})):
        t0 = time.perf_counter()
        tables = {}
        for backend in ("kernel", "torch"):
            cfg = BOConfig(slice_config=FAST_CONFIG, backend=backend, fit_backend="torch")
            _, res = run_job(cfg, 16, 2, fn, **job)
            tables[backend] = np.stack([space.encode(t.config) for t in res.trials])
        diff = float(np.abs(tables["kernel"] - tables["torch"]).max())
        print(f"invariance ({label}): 16 trials kernel vs torch scoring max |Δ| "
              f"{diff:.3e} (tol 1e-9) in {time.perf_counter() - t0:.1f} s", flush=True)
        if tables["kernel"].shape != (16, 6) or diff > 1e-9:
            fail(f"scoring backends disagree on the card ({label})")
    phase_done("3 invariance", t_phase)

    # ------------------------------------------ 4.–5. main and multi paths
    paper = dict(
        slice_config=PAPER_CONFIG,
        acq=AcqOptConfig(num_anchors=1024, num_refine=8, refine_steps=25),
        refit_every=1, backend="kernel", fit_backend="kernel",
        # the constant liar folds the in-flight trials into the factor by
        # rank-1 appends (the cross-row kernel); with "exclude" and a refit
        # after every observation the engine would never append
        pending_strategy="liar",
    )

    def drive(label, cfg, trials, parallel, scorer, fn=objective, **job):
        """One job with spans on and launch counts set to 0 just before it;
        checks the trials, the launches of ``scorer`` and both Matérn
        kernels, and that the row buckets it scored were held against the
        plain version in phase 2; prints the decision latency."""
        must_launch = (scorer, "matern52_gram", "matern52_cross")
        telemetry.get().reset()
        telemetry.set_enabled(True)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        tuner, res = run_job(cfg, trials, parallel, fn, **job)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        telemetry.set_enabled(False)

        done = res.trials
        if not done or any(t.state != "COMPLETED" for t in done):
            fail(f"{label}: {len(done)} trials, not all completed")
        if "max_cost" not in job and len(done) != trials:
            fail(f"{label}: {len(done)} trials, not {trials}")
        enc = np.stack([space.encode(t.config) for t in done])
        if len({tuple(np.round(e, 12)) for e in enc}) != len(done):
            fail(f"{label}: duplicate configurations")
        for t in done:
            for p in space.parameters:
                v = t.config[p.name]
                if not (p.low <= v <= p.high * (1 + 1e-12)):
                    fail(f"{label}: {p.name}={v} outside [{p.low}, {p.high}]")
        missing = [k for k in must_launch if launches[k] == 0]
        if missing:
            fail(f"{label} never launched {missing}")

        spans = {}
        by_id = {}
        for ev in telemetry.get().trace_events():
            if ev.get("kind") == "span":
                spans.setdefault(ev["name"], []).append(ev["dur"] * 1e3)
                by_id[ev["span_id"]] = ev
        decisions = len(spans.get("suggest.posterior", []))

        def med(span_name):
            v = spans.get(span_name)
            return f"{statistics.median(v):.2f} ms (n={len(v)})" if v else "none"

        # Decision latency is over GP decisions: the suggest.decide spans
        # that enclose a suggest.posterior span (cold-start decisions run
        # no GP).
        gp_ids = set()
        for ev in by_id.values():
            if ev["name"] == "suggest.posterior":
                up = by_id.get(ev["parent_id"])
                while up is not None and up["name"] != "suggest.decide":
                    up = by_id.get(up["parent_id"])
                if up is not None:
                    gp_ids.add(up["span_id"])
        dec = sorted(by_id[i]["dur"] * 1e3 for i in gp_ids)
        print(f"{label}: {len(done)} trials in {wall:.1f} s, {decisions} GP "
              f"decisions, best objective {res.best_objective:.6f}", flush=True)
        if not dec or len(dec) != decisions:
            fail(f"{label}: {len(dec)} GP decision spans for {decisions} posteriors")
        # A decision over n observations scores a factor of n rows plus the
        # fantasized pending trials and interim picks: at most
        # min(n + parallel, trials) − 1 rows, padded to a power-of-two bucket.
        ns = [ev["attrs"]["n"] for ev in by_id.values()
              if ev["name"] == "suggest.posterior"]
        buckets = set()
        b, b_max = bucket_size(min(ns)), bucket_size(min(max(ns) + parallel, trials) - 1)
        while b <= b_max:
            buckets.add(b)
            b *= 2
        print(f"  rows scored: {min(ns)}..{min(max(ns) + parallel, trials) - 1}, "
              f"buckets {sorted(buckets)} (checked in phase 2: "
              f"{sorted(checked_buckets[scorer])})", flush=True)
        if not buckets <= checked_buckets[scorer]:
            fail(f"{label}: {scorer} ran at buckets "
                 f"{sorted(buckets - checked_buckets[scorer])} not held against "
                 "its plain version")
        p80 = dec[min(len(dec) - 1, int(math.ceil(0.8 * len(dec))) - 1)]
        print(f"  decision latency (GP decisions, n={len(dec)}): p50 "
              f"{statistics.median(dec):.2f} ms, p80 {p80:.2f} ms, max "
              f"{dec[-1]:.2f} ms; {len(dec) / (sum(dec) / 1e3):.3f} GP decisions "
              f"per engine-busy second", flush=True)
        for span in ("suggest.decide", "suggest.gphp_fit", "suggest.factorize",
                     "suggest.rank1_append", "suggest.head_alphas",
                     "suggest.acq_opt", "suggest.dedup"):
            print(f"  span {span}: median {med(span)}", flush=True)
        for k, v in launches.items():
            print(f"  launches {k}: {v} ({v / max(decisions, 1):.1f} per GP decision)",
                  flush=True)
        return tuner, res, launches

    # 4. the single-metric main path
    t_phase = time.perf_counter()
    _, res, main_launches = drive("main path", BOConfig(**paper), 64, 4, "acq_score")
    if not math.isfinite(res.best_objective):
        fail("main path: best objective not finite")
    phase_done("4 main path", t_phase)

    # 5. multi-metric and cost-aware paths at the same width
    t_phase = time.perf_counter()
    multi_launches = {k: 0 for k in K.KERNEL_NAMES}
    cfg_multi = BOConfig(num_scalarizations=16, **paper)

    _, res, launches = drive("(a) constrained", cfg_multi, 24, 4, "acq_score_multi",
                             metric_objective, metrics=CONSTRAINED)
    best = res.best_trial
    if best is None or not math.isfinite(best.objective) or not MetricSet(
            CONSTRAINED).feasible(best.metrics):
        fail("(a) constrained: no finite best feasible objective")
    print(f"  best feasible loss {best.objective:.6f} at latency "
          f"{best.metrics['latency']:.4f} <= {LATENCY_MAX}", flush=True)
    multi_launches = {k: multi_launches[k] + launches[k] for k in launches}

    _, res, launches = drive("(b) pareto", cfg_multi, 24, 4, "acq_score_multi",
                             metric_objective, metrics=PARETO)
    front = res.pareto_front
    ms = MetricSet(PARETO)
    if not front:
        fail("(b) pareto: empty Pareto front")
    ys = np.asarray([[t.metrics["loss"], t.metrics["size"]] for t in front])
    if not pareto_mask(ys).all() or not all(ms.feasible(t.metrics) for t in front):
        fail("(b) pareto: front holds a dominated or infeasible trial")
    print(f"  pareto front: {len(front)} trials {[t.trial_id for t in front]}",
          flush=True)
    multi_launches = {k: multi_launches[k] + launches[k] for k in launches}

    max_cost, max_trial_cost = 300.0, 10 * (1.0 + 0.2 * 10)
    tuner, res, launches = drive(
        "(c) cost-aware", BOConfig(cost_aware=True, **paper), 24, 4,
        "acq_score_multi", max_cost=max_cost)
    spent = tuner.budget_ledger.spent
    print(f"  spent {spent:.4f} of max_cost {max_cost} over {len(res.trials)} "
          f"trials (bound {max_cost + 4 * max_trial_cost})", flush=True)
    if not tuner.budget_ledger.exhausted or len(res.trials) >= 24:
        fail("(c) cost-aware: the budget did not stop the job early")
    if spent > max_cost + 4 * max_trial_cost:
        fail("(c) cost-aware: spend beyond max_cost plus the in-flight trials")
    multi_launches = {k: multi_launches[k] + launches[k] for k in launches}
    phase_done("5 multi-metric and cost-aware paths", t_phase)

    path_launches = {"main": main_launches, "multi": multi_launches}
    line = {"kernels": []}
    for kname in K.KERNEL_NAMES:
        r = results.get(kname)
        if r is None:
            fail(f"no kernel-phase numbers for {kname}")
        line["kernels"].append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname],
            "launches": path_launches[PATH_OF[kname]][kname],
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
