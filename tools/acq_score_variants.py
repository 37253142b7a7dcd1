"""Check and time the anchor-scoring CUDA kernels (``acq_score``,
``acq_score_multi``) on one NVIDIA card, beside an earlier version of their
sources and against edits of their own:

    python3 tools/acq_score_variants.py [--parent DIR] [--only sweep|variants]

Run from a checkout's root on a machine with the card, ``nvcc`` and
CUDA-enabled torch (no JAX needed). Prints:

* the registers and spills of each scoring kernel, and its SASS opcode mix
  (``DMMA`` is the f64 product on the tensor cores);
* the variants: ``acq_score`` built from edits of ``csrc/acq_walk.cuh`` or
  ``csrc/acq_score.cu`` that each drop one part of the work (the warp's
  transcendentals, the K* entries, the K* pass, the products, the ring's
  later copies, the epilogue; and an empty walk, the launch's own floor),
  timed at the main path's shapes, n = 32, n = 8 (f32), n = 1024 and the
  re-rank, each twice in turns with the kernel as it is;
* for a sweep of cases — row buckets 8–2048 (the small ones padded past
  their live rows as the engine pads them), the anchor grid m = 1024 and
  the re-rank m = 8, d = 6 and 20, f64 and f32, ``acq_score_multi`` in its
  four modes — the error against the plain version (f64 within 1e-9, f32
  within 2e-2 of max(1, max |plain|); the re-rank's f32 past 1024 rows is
  printed, not held) and, for f32, each side's error against the f64
  plain version; the launch plan; the median kernel time over 20 launches
  (CUDA events, host work hidden behind a device sleep);
* with ``--parent DIR`` (a ``csrc/`` directory of an earlier tree, whose
  entry points take no plan: ``acq_score_f64(10 inputs, y_best, kappa,
  out, S, m, n, d, acq, stream)``), the same cases through kernels built
  from DIR, timed in turns with the current ones (parent, kernel, kernel,
  parent), and their error against the plain version;
* the SM clock and power while ``acq_score`` f64 at n = 1024 runs back to
  back for 3 s.

Exits non-zero if a held case disagrees with its plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "build" / "acq_score_variants"
S = 10
TOL = {"f64": 1e-9, "f32": 2e-2}
# (M, C) of each multi mode, as the multi-metric paths give them
MULTI = {"constrained": (2, 1), "pareto": (3, 1), "rungs": (4, 0), "cost": (2, 0)}
SINGLE_CASES = (  # (live, n, d, m)
    [(5, 8, 6, 1024), (13, 16, 6, 1024), (27, 32, 6, 1024), (50, 64, 6, 1024)]
    + [(n, n, 6, 1024) for n in (64, 256, 1024, 2048)]
    + [(n, n, 20, 1024) for n in (64, 1024)]
    + [(n, n, 6, 8) for n in (64, 256, 1024, 2048)]
)
# f32 scoring is checked where chip_smoke.py checks it; the re-rank's f32 at
# n ≥ 1024 is printed against the f64 plain version but not held to 2e-2
F32_UNHELD = {(n, 8) for n in (1024, 2048)}
MULTI_CASES = (  # (live, n, m, modes)
    [(7, 8, 1024, tuple(MULTI)), (23, 32, 1024, tuple(MULTI)), (64, 64, 1024, tuple(MULTI)),
     (1024, 1024, 1024, tuple(MULTI)), (2048, 2048, 1024, ("pareto", "rungs")),
     (23, 32, 8, ("pareto",)), (1024, 1024, 8, ("pareto",))]
)
OPS = ("DMMA", "DFMA", "DMUL", "DADD", "FFMA", "FMUL", "LDS", "LDGSTS", "MUFU", "BAR", "SHFL")


def build_parent(csrc: Path) -> dict:
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("acq_score", "acq_score_multi"):
        cmd = [_build._nvcc(), *_build._FLAGS, "-I", str(csrc), "-o",
               str(OUT / f"libparent_{name}.so"), str(csrc / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc parent {name} failed:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"libparent_{name}.so"))
        nptr, nint = (10, 5) if name == "acq_score" else (13, 10)
        for sfx in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{sfx}")
            fn.argtypes = ([ctypes.c_void_p] * nptr + [ctypes.c_double] * 2 + [ctypes.c_void_p]
                           + [ctypes.c_int] * nint + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
# Edits of acq_walk.cuh or acq_score.cu, each removing one part of the
# work so its share of the time shows (the results are then wrong and not
# checked); "empty" returns at once: the launch's own floor.
EDITS = {
    "no_warp": [("return warp_scale(x, w.wa[i], w.wb[i], w.won[i], w.inv_ell[i]);",
                 "return x * w.inv_ell[i];")],
    "no_kstar": [("out[(size_t)j * ld + e - j * TA] = matern52(r2[u], a2) * mk[u];",
                  "out[(size_t)j * ld + e - j * TA] = mk[u];"),
                 ("    for (int f = 0; f < dl; ++f) {\n#pragma unroll\n      for (int u = 0;",
                  "    for (int f = 0; f < 0; ++f) {\n#pragma unroll\n      for (int u = 0;")],
    "no_pass": [("  if constexpr (!SINGLE) {\n    const size_t total",
                 "  if (w.n < 0) {\n    const size_t total")],
    "no_mma": [("      if (any) {\n        tile.step(", "      if (any && w.n < 0) {\n        tile.step(")],
    "no_loads": [("    if (!all_in && c + STAGES - 1 < rw.nch) {",
                  "    if (!all_in && c + STAGES - 1 < 0) {")],
    "no_epilogue": [("  if (w.pairs > 1) return;\n  const int s = blockIdx.z;",
                     "  if (w.pairs > 0) return;\n  const int s = blockIdx.z;")],
    "empty": [("  const Layout ly(TA, bm, n, w.dp, SINGLE, sizeof(T));",
               "  if (w.n > 0) return Result<T>{smem, smem};\n  const Layout ly(TA, bm, n, w.dp, SINGLE, sizeof(T));")],
}


def build_variants() -> dict:
    """lib per variant of acq_score.cu (it or the walk edited), built in
    parallel."""
    from repro_torch.kernels import _build

    files = ("acq_walk.cuh", "acq_score.cu")
    procs = {}
    for name, pairs in EDITS.items():
        texts = {f: (CSRC / f).read_text() for f in files}
        for old, new in pairs:
            f = next((f for f in files if old in texts[f]), None)
            if f is None:
                sys.exit(f"variant {name}: '{old}' is in neither {files}")
            texts[f] = texts[f].replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for f in (*files, "matern52_common.cuh"):
            (d / f).write_text(texts.get(f) or (CSRC / f).read_text())
        cmd = [_build._nvcc(), *_build._FLAGS, "-I", str(d), "-o", str(d / "libacq_score.so"),
               str(d / "acq_score.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc variant {name} failed:\n{log}")
        lib = ctypes.CDLL(str(OUT / name / "libacq_score.so"))
        for sfx in ("f32", "f64"):
            fn = getattr(lib, f"acq_score_{sfx}")
            fn.argtypes = _build._ARGTYPES["acq_score"]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def sass_mix() -> None:
    """Opcode counts of every scoring kernel in the built libraries."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    for lib in ("acq_score", "acq_score_multi"):
        for line in _build.ptxas_report(lib).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas {lib}: {line.strip()}", flush=True)
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build.build_dir() / f"lib{lib}.so")],
                              capture_output=True, text=True).stdout
        for func in re.split(r"\n\s*Function : ", sass)[1:]:
            name = func.split("\n", 1)[0].strip()
            ops = Counter(m.group(1).split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", func))
            mix = ", ".join(f"{op} {ops[op]}" for op in OPS if ops[op])
            print(f"sass {lib} {name[-70:]}: {sum(ops.values())} instructions ({mix})",
                  flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="csrc/ directory of an earlier tree to time beside this one")
    parser.add_argument("--only", choices=("sweep", "variants"), default=None,
                        help="run only the checked sweep or only the variants")
    args = parser.parse_args()

    import numpy as np
    import torch

    from repro_torch.core.gp import gp as G
    from repro_torch.core.gp import params as P
    from repro_torch.core.gp.multi import solve_head_alphas
    from repro_torch.core.optimize_acq import MultiMetricHead
    from repro_torch.kernels import _build
    from repro_torch.kernels.acq_score import kernel as K
    from repro_torch.kernels.acq_score.ops import pack_inputs, pack_multi_inputs
    from repro_torch.kernels.acq_score.plain import acq_score_multi_plain, acq_score_plain

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    sass_mix()
    parent = build_parent(args.parent) if args.parent else None
    dev = torch.device("cuda")
    sms, limit = K._card("acq_score", 0)
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)  # invariant: fresh-rng -- a one-shot probe's seeded inputs; nothing is checkpointed or replayed

    def posterior(n, d, live):
        x_np = np.zeros((n, d))
        x_np[:live] = rng.random((live, d))
        y_np = np.zeros(n)
        y_np[:live] = rng.standard_normal(live)
        base = P.default_params(d).pack().numpy()
        packed = np.stack([base + 0.1 * rng.standard_normal(3 * d + 2) for _ in range(S)])
        params = P.GPHyperParams.unpack(torch.as_tensor(packed).to(dev), d)
        mask = torch.as_tensor(np.arange(n) < live).to(dev)
        post = G.fit_posterior_batch(torch.as_tensor(x_np).to(dev), torch.as_tensor(y_np).to(dev),
                                     params, mask, with_inverse=True)
        return post, x_np[:live]

    def median_ms(fn, reps=20):
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

    bad = []

    exact = {}  # label -> the f64 plain result, to judge f32 by

    def run(label, dt, kfn, pfn, parent_fn, plan, held=True):
        got = kfn()
        want = pfn()
        torch.cuda.synchronize()
        scale = max(1.0, float(want.abs().max()))
        err = float((got.double() - want.double()).abs().max())
        ok = bool(torch.isfinite(got).all()) and (err <= TOL[dt] * scale or not held)
        verdict = ("ok" if ok else "FAIL") if held else "not held"
        line = (f"{label} {dt}: err {err:.3e} ({verdict}, tol {TOL[dt]:.0e} x "
                f"{scale:.3g}) plan ta={plan.ta} bm={plan.bm} pairs={plan.pairs} "
                f"single={plan.single} blocks={plan.blocks} smem={plan.smem}")
        if dt == "f64":
            exact[label] = want.double()
        else:  # f32 kernel and plain, each against the f64 plain version
            ref = exact[label]
            line += (f" (vs f64: kernel {float((got.double() - ref).abs().max()):.3e}, "
                     f"plain {float((want.double() - ref).abs().max()):.3e})")
        if not ok:
            bad.append(f"{label} {dt}")
        if parent_fn is None:
            line += f" kernel_ms {median_ms(kfn):.5f}"
        else:
            perr = float((parent_fn().double() - want.double()).abs().max())
            t = [median_ms(f) for f in (parent_fn, kfn, kfn, parent_fn)]
            line += (f" kernel_ms {t[1]:.5f} {t[2]:.5f} parent_ms {t[0]:.5f} {t[3]:.5f} "
                     f"(parent err {perr:.3e}) speedup {(t[0] + t[3]) / (t[1] + t[2]):.2f}x")
        print(line, flush=True)

    if args.only != "sweep":
        libs = build_variants()
        for n, m, dt, tdt in ((64, 1024, "f64", torch.float64), (64, 1024, "f32", torch.float32),
                              (32, 1024, "f32", torch.float32), (8, 1024, "f32", torch.float32),
                              (1024, 1024, "f64", torch.float64), (64, 8, "f64", torch.float64)):
            post, _ = posterior(n, 6, n)
            a = pack_inputs(post, torch.as_tensor(rng.random((m, 6))).to(dev), tdt)
            dp = a[0].shape[1]
            plan = K.walk_plan(S, m, n, dp, a[0].element_size(), sms, limit)
            size = plan.workspace(S, m, n, dp, 1)
            ws = torch.empty(size, dtype=tdt, device=dev)
            out = torch.empty((S, m), dtype=tdt, device=dev)

            def variant(name, a=a, out=out, ws=ws, plan=plan, dt=dt, n=n, m=m, dp=dp):
                fn = getattr(libs[name], f"acq_score_{dt}")
                err = fn(*(t.data_ptr() for t in a), -1.0, 2.0, out.data_ptr(), ws.data_ptr(),
                         S, m, n, dp, 0, plan.ta, plan.bm, plan.smem, stream)
                if err:
                    sys.exit(f"variant {name}: launch failed ({err})")
                return out

            t = {"kernel": [median_ms(lambda a=a: K.acq_score_kernel(*a, -1.0, 2.0, "ei"))]}
            for name in EDITS:
                t[name] = [median_ms(lambda name=name: variant(name))]
            for name in reversed(EDITS):
                t[name].append(median_ms(lambda name=name: variant(name)))
            t["kernel"].append(median_ms(lambda a=a: K.acq_score_kernel(*a, -1.0, 2.0, "ei")))
            print(f"variants acq_score {dt} S={S} m={m} n={n} d=6 (plan ta={plan.ta} "
                  f"bm={plan.bm} pairs={plan.pairs} single={plan.single}): "
                  + ", ".join(f"{k} {v[0]:.5f} {v[1]:.5f}" for k, v in t.items()), flush=True)
            del post
    if args.only == "variants":
        return

    for live, n, d, m in SINGLE_CASES:
        post, _ = posterior(n, d, live)
        x_star = torch.as_tensor(rng.random((m, d))).to(dev)
        for dt, tdt in (("f64", torch.float64), ("f32", torch.float32)):
            a = pack_inputs(post, x_star, tdt)
            plan = K.walk_plan(S, m, n, a[0].shape[1], a[0].element_size(), sms, limit)
            pfn = None
            if parent:
                out = torch.empty((S, m), dtype=tdt, device=dev)
                fn = getattr(parent["acq_score"], f"acq_score_{dt}")

                def pfn(a=a, out=out, fn=fn):
                    fn(*(t.data_ptr() for t in a), -1.0, 2.0, out.data_ptr(), S, m, n,
                       a[0].shape[1], 0, stream)
                    return out
            pad = "" if live == n else f" live={live}"
            run(f"acq_score S={S} m={m} n={n}{pad} d={d}", dt,
                lambda a=a: K.acq_score_kernel(*a, -1.0, 2.0, "ei"),
                lambda a=a: acq_score_plain(*a, -1.0, 2.0, "ei"), pfn, plan,
                held=dt == "f64" or (n, m) not in F32_UNHELD)
        del post

    d = 6
    for live, n, m, modes in MULTI_CASES:
        post, x_np = posterior(n, d, live)
        x_star = torch.as_tensor(rng.random((m, d))).to(dev)
        yl = np.sin(3.0 * x_np @ rng.standard_normal((d, 4)) + rng.random(4)).T
        yl = (yl - yl.mean(axis=1, keepdims=True)) / yl.std(axis=1, keepdims=True)
        yh = np.zeros((4, n))
        yh[:, :live] = yl
        alphas = solve_head_alphas(post, torch.as_tensor(yh).to(dev))
        for mode in modes:
            M, C = MULTI[mode]
            draws, ybw, y_best = np.array([[1.0]]), np.zeros(1), float(yl[0].min())
            if mode == "constrained":
                draws, ybw = np.zeros((1, 1)), np.zeros(1)
            elif mode == "pareto":
                g = -np.log1p(-rng.random((16, 2)))
                draws = g / g.sum(axis=1, keepdims=True)
                ybw = (yl[:2].T @ draws.T).min(axis=0)
            elif mode == "rungs":
                r = np.array([1.0, 3.0, 9.0])
                draws = np.concatenate(([0.5], 0.5 * r / r.sum()))[None, :]
                ybw = yl.min(axis=1)
            head = MultiMetricHead(
                alphas=alphas[:, :M].contiguous(), t_std=torch.full((C,), 0.3, device=dev),
                y_best=y_best, has_feasible=True, weights=torch.as_tensor(draws).to(dev),
                y_best_w=torch.as_tensor(ybw).to(dev))
            for dt, tdt in (("f64", torch.float64), ("f32", torch.float32)):
                a = pack_multi_inputs(post, head, x_star, mode, tdt)
                plan = K.walk_plan(S, m, n, a[0].shape[1], a[0].element_size(), sms, limit)
                pfn = None
                if parent:
                    out = torch.empty((S, m), dtype=tdt, device=dev)
                    fn = getattr(parent["acq_score_multi"], f"acq_score_multi_{dt}")
                    wr, wc = a[11].shape

                    def pfn(a=a, out=out, fn=fn, wr=wr, wc=wc, mode=mode, C=C, M=M):
                        fn(*(t.data_ptr() for t in a[:13]), a[13], 1.0 if a[14] else 0.0,
                           out.data_ptr(), S, m, n, a[0].shape[1], M, C, wr, wc,
                           a[12].shape[0], K.MULTI_MODES[mode], stream)
                        return out
                pad = "" if live == n else f" live={live}"
                run(f"acq_score_multi {mode} M={M} S={S} m={m} n={n}{pad} d={d}", dt,
                    lambda a=a: K.acq_score_multi_kernel(*a),
                    lambda a=a: acq_score_multi_plain(*a), pfn, plan)
        del post, alphas

    # clock and power under load
    post, _ = posterior(1024, 6, 1024)
    a = pack_inputs(post, torch.as_tensor(rng.random((1024, 6))).to(dev), torch.float64)
    samples = []
    done = threading.Event()

    def sample():
        while not done.is_set():
            q = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                "--format=csv,noheader,nounits"], capture_output=True, text=True)
            samples.append(q.stdout.strip())
            time.sleep(0.2)

    th = threading.Thread(target=sample)
    th.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 3.0:
        for _ in range(50):
            K.acq_score_kernel(*a, -1.0, 2.0, "ei")
        torch.cuda.synchronize()
    done.set()
    th.join()
    clocks = [float(s.split(",")[0]) for s in samples if s]
    watts = [float(s.split(",")[1]) for s in samples if s]
    print(f"under load (acq_score f64 n=1024 back to back, 3 s): SM clock "
          f"{min(clocks):.0f}-{max(clocks):.0f} MHz, power {min(watts):.0f}-{max(watts):.0f} W",
          flush=True)
    if bad:
        sys.exit(f"FAIL: {bad}")


if __name__ == "__main__":
    main()
