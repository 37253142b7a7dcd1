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
   pads them, at the exact backend's largest bucket, 2048 rows, and at the
   decision's re-rank of 8 points): max error against the stated tolerance,
   kernel and plain
   times (CUDA events, median), and the card's lower bound for the same
   work, beside the launch floor (an empty kernel's time) where the kernel
   is within twice it; ``matern52_cross`` (a pending set's cross rows in
   one launch) also bit for bit against one launch a row and
   ``matern52_operand`` (the factorize operand) against the torch
   composition around ``matern52_gram``, and the engine's pending fold
   through one rows launch against the sequential fold, bit for bit, at
   buckets 8–64; and ``slice_chain`` — a whole slice-sampling chain at the paper's
   configuration in one launch — against its plain version (the host
   chain) on the same draw table, at each row bucket 8–256 with both gram
   types and once from a start where the float32 gram is indefinite (every
   shrink runs out): kept samples to 1e-9 and equal counts, a differing
   branch passing only as a near-tie of g and its slice level; each chain
   prints the kernel's cluster width W, rounds and points evaluated beside
   the chain's own counts; (i) the subset backend's shapes: the paper's
   chain timed on 512 and 1024 live rows (f32 gram), held against the
   plain chain in full at 512 rows and shortened at 1024 (its updates
   printed), ``matern52_operand`` on 1024 rows and ``matern52_cross`` and
   ``acq_score`` at the 2048 bucket;
3. invariance — the same short job twice on the card, anchors scored by the
   fused kernel and by the torch composition; the trial tables must agree;
   then the same for a Pareto job with a constraint (``acq_score_multi``);
4. main path — a 64-trial single-metric tuning job at the paper's engine
   configuration (slice sampler 300/250/5, 1024 anchors, 8 refined for 25
   Adam steps, refit after every observation) with the single-metric
   kernels on; each refit is one ``slice_chain`` launch; the slowest GP
   decision is broken down (rows, row bucket, its chain's evaluations, NaN
   factors, exhausted shrinks and rounds, its spans);
5. multi-metric, cost-aware and kriging-believer paths — three 24-trial
   jobs at the same engine configuration: constrained (objective + latency
   constraint), Pareto (two objectives + the constraint) and cost-aware EI
   per unit cost with a ``max_cost`` that stops the job early; then a
   16-trial single-metric job whose pending trials are fantasized at the
   posterior mean (kriging believer: ``matern52_gram`` predicts each);
   every GP decision of phases 4–5 launches ``matern52_cross`` once for its
   pending set (and once a row for interim picks) and
   ``matern52_operand`` once a factorization;
8. the §5 paths (run after phase 5) — at the same engine configuration:
   (e) a 24-trial job whose objective reports its learning curve, once
   under the median rule and once under ASHA (each must stop a trial early;
   the table under fused scoring must equal the torch scoring's); (f) two
   24-trial jobs on one ``SelectionService``, decisions interleaved, with
   the shared GPHP pool (adoptions > 0; ``slice_chain`` launches equal the
   refits and are fewer than the GP decisions), again under a factor arena
   that evicts at every decision (both tables bit for bit), and without the
   pool, then with a refit every 3 observations, roomy and evicting (the
   evicted factors rebuilt by replaying the appends); (g) a 24-trial
   multi-fidelity job in service mode with in-service ASHA
   (``acq_score_multi``'s rungs mode launches twice a slot on every
   rung-aware decision, exactly; a trial stopped at a rung; fused and torch
   tables equal); (h) the reference's BO-beats-random quality gate on the
   quadratic table with the kernels on;
9. large n, per-head chains and the wire (run after phase 8) — at the same
   engine configuration: (j) a 20-trial job on a store preloaded with
   100,000 seeded observations, the subset posterior at its defaults
   (``n_switch`` 2048, ``max_inducing`` 1024), refit every 10
   observations (2 boundary refits), each decision printed (selection,
   chain and its NaN counts, spans, peak device memory); ``slice_chain``
   launches equal the refits, ``acq_score`` scores only the 1024/2048
   buckets phase 2 held, ``matern52_cross`` once a pending set and interim
   pick, fused = torch tables; (k) a 24-trial constrained job with
   ``per_head_gphp`` (2 ``slice_chain`` launches a refit, no
   ``acq_score_multi`` launch, fused = torch tables); (l) two engine
   replicas, one a real subprocess on the card (``python -m
   repro_torch.distributed.engine_server --port 0``, its address read from
   its first line), one in-process: a 24-trial ``Tuner(service=
   RemoteService([...]))`` through both, the subprocess SIGKILLed
   mid-stream, must give an in-process ``SelectionService`` run's trial
   table bit for bit with no failed attempt; then (j)'s job fails over the
   same way (a chunked-snapshot restore of its 100,000-row store, then
   the replay) and must give (j)'s table;
6. serve path — the LM workload's serving path on recurrentgemma-9b at its
   full published widths and depth (38 layers, 7.48e9 parameters, seeded
   random weights made on the card): first ``flash_attention`` and
   ``rglru_scan`` against their plain versions at the serving shapes (and
   the JAX package's kernel sweep; bf16 attention also at each (G, Dh,
   window) of the registry's attention archs), with SDPA timed as the
   yardstick, and training's flash-attention pair — the forward's O and
   row LSE against the plain forward, the backward's three kernels against
   the plain backward (gradients by the gap of norms), and the pair's
   forward and backward timed beside the composition training ran before
   it — at granite-moe-1b-a400m's two microbatches, granite-4.0-h-small's
   attention, recurrentgemma-9b's local attention (Dh 256) and a ragged,
   windowed, soft-capped shape; then
   four 3000-token requests through ``greedy_generate`` for 16 tokens with
   the kernels (12 ``flash_attention`` and 26 ``rglru_scan`` launches per
   prefill); prefill, decode and weight-cast times; decode after prefill
   against the full forward one token longer; and the same requests through
   the plain torch composition, teacher-forced with the kernel run's
   tokens, whose prefill logits, caches and decode logits must agree. Then
   ``decode_attention``, which no model calls: its own path is one
   flash-decode per swa layer on the prefill's wrapped ring caches at
   t = 3000 (12 launches); then it is held against its plain version there
   (bf16, per element), at gemma3-27b's global decode shape (32,768 slots,
   bf16), on the JAX package's sweep in f32 with one row left with no
   valid slot and at G = 1–16, Dh 64–256 in bf16, SDPA timed as the
   yardstick;
7. mamba path — falcon-mamba-7b at its full published widths and depth (64
   Mamba layers, 7.27e9 parameters, seeded on the card, after phase 6's
   model is freed): ``mamba_scan`` against its plain version at the serving
   shape, the JAX package's sweep and the kernel's edges (d_state 1, 3,
   5, 8 and 16, ragged d_inner, S from 1 to 3000, Δ tiny and large; y and
   the last state, each case with its share of the bytes and the operations
   bound), then the same serving run, checks and torch composition as phase 6 (64 ``mamba_scan``
   launches per prefill), then decode after prefill and the torch
   composition's prefill once more with the model computing in float32;
10. training and the tuning job (run after phase 7) — the paper's use
   case on granite-moe-1b-a400m at its full published widths and depth (24
   layers, 32 experts top-8, 1.33e9 parameters, seeded on the card): (m)
   four 3000-token requests served with the kernels for 16 tokens (24
   ``flash_attention`` launches a prefill) and held against the torch
   composition, which takes the kernel run's expert choices (the tokens
   whose own top-8 set differs are counted), in bf16 and in float32; ten
   training steps of 16 × 1024 synthetic tokens (2 microbatches, remat,
   AdamW; the step replayed from a CUDA graph after two eager steps) —
   finite losses and gradient norms, the last loss below the first, the
   step time, tokens/s, peak memory and a ``torch.profiler`` step; a
   restart at 2 layers under deterministic algorithms (6 steps straight
   against 3, a checkpoint, a fresh model loaded from it and 3 more: every
   parameter, m, v and the step bit for bit); (n) an 8-trial BO tuning job
   (``launch/train.py``'s space and objective at 60 steps of 8 × 64 tokens,
   eval every 10; two trials in flight on ``ThreadBackend``; the median
   rule; ``BOConfig(num_init=3, fit_backend="kernel").fast()``): every
   trial completed or stopped with finite reports, none failed, the best
   eval loss below the untrained model's, ``acq_score`` 2 launches and
   ``slice_chain`` at most 1 a GP decision at row buckets phase 2 held;
   the trial table, the decisions' p50 and peak memory;
11. sharding, mesh and dry-run (run after phase 10) — (o) granite-moe-1b-
   a400m at full width and depth through ``make_local_mesh()`` = (1, 1)
   over a real one-rank NCCL group, seeded as phase 10 seeds it, under
   ``DEFAULT_RULES`` (the ``ShardCtx`` constraints and the ``local_map``
   kernel calls live): phase 10's four 3000-token requests for 16 greedy
   tokens with the kernels (24 ``flash_attention`` launches, one prefill),
   and 3 + 3 training steps of 16 × 1024 tokens; the tokens, prefill
   logits and KV caches, each step's metrics and every parameter after 3
   steps bit for bit with the same run with no mesh; prefill ms, step
   median and peak memory beside the run with no mesh and phase 10's;
   (p) ``python -m repro_torch.launch.dryrun`` for qwen3-moe-235b-a22b ×
   ``train_4k`` and × ``decode_32k`` on the 16×16 production mesh
   (subprocesses on the card's host over a fake process group): status OK,
   per-device parameter bytes equal to the rules' shape arithmetic, the
   decode cell on its ``cache_seq="model"`` override, each record's
   roofline terms on ``H100_SXM``, bottleneck, peak estimate and
   ``fits_hbm``; (q) the dry-run of (o)'s training step on a (1, 1) mesh:
   its per-device peak within 25% of (o)'s ``max_memory_allocated``, its
   FLOPs beside ``model_flops``, the step's share of the bf16 peak;
12. the Mamba-2 scan (run after phase 7) — ``kernels/ssd``'s pair at
   granite-4.0-h-small's shape (1 × 4096, 128 heads of 64, state 128, one
   group, chunks of 256), a ragged two-batch length, two groups and the
   reduced test config's shape: ``ssd_pack`` bit for bit against
   ``contiguous`` on the mixer's views of its conv output; ``ssd_fwd``'s y
   and ``ssd_bwd``'s dx, dΔ, dA, dB and dC against the composition
   ``models/mamba2.py::ssd`` (and autograd through it) in float32 on the
   same bf16 inputs, each also no farther than the bf16 composition but dA;
   two backward runs bit for bit; then one mixer at the cell's widths
   trained forward and backward on a 1 × 4096 microbatch, the route
   counted (``mamba2.ssd.kernel``), timed beside the composition.

Launch counts are set to 0 just before each job of phases 4, 5, 8, 9 and
10, the serving runs of phases 6, 7, 10 and 11, the flash-decode path and
phase 12's mixer,
and read just after; each must launch every kernel of its path (jobs: and score only row
buckets that phase 2 held against the plain version). Prints one line per
case (with the rate of the resource that bounds it and its share of the
bound) and each phase's wall time, then a
JSON line of per-kernel numbers (``launches`` from the kernel's own path,
``s5_launches`` from each path of phase 8, ``large_n_launches`` from each
of phase 9, ``train_launches`` from (m)'s serving run, its training steps
(the backward kernels' own path: the flash-attention pair must launch) and
(n)'s job,
``mesh_launches`` from phase 11 (o)'s serving run; the SSD pair's
``launches`` from phase 12's mixer), then
as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, with no result line, on
any failure — including no visible card.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
# cores ("f64_tc"), which a float64 matrix product can use; BF16 on the
# tensor cores ("bf16"). main() adds "exp": f32 exponentials on the
# special-function units, 16 per clock per SM on sm_90 (CUDA C++
# Programming Guide, arithmetic instruction throughput), times the SM count
# and the maximum SM clock the card reports.
# The SXM part's "hbm" and "bf16" come from repro_torch.launch.roofline's
# H100_SXM (the same data sheet), which main() reads once the port imports.
PEAKS = {
    "SXM": {"f64": 34e12, "f64_tc": 67e12, "f32": 67e12},
    "PCIe": {"hbm": 2.0e12, "f64": 26e12, "f64_tc": 51e12, "f32": 51e12, "bf16": 756e12},
    "NVL": {"hbm": 3.9e12, "f64": 30e12, "f64_tc": 60e12, "f32": 60e12, "bf16": 835e12},
}

REPLACES = {
    "acq_score": "src/repro/kernels/acq_score/kernel.py:314",
    "acq_score_multi": "src/repro/kernels/acq_score/kernel.py:254",
    "matern52_gram": "src/repro/kernels/matern52/kernel.py:148",
    "matern52_cross": "src/repro/kernels/matern52/kernel.py:117",
    # the factorize step's route of matern52_gram_pallas
    # (src/repro/core/gp/gp.py:76, its masked gram)
    "matern52_operand": "src/repro/kernels/matern52/kernel.py:148",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:102",
    # training's backward: XLA's fusion of the JAX model's attention
    # (src/repro/models/attention.py), no Pallas kernel
    "flash_attention_bwd_dot": "none (XLA's fusion of src/repro/models/attention.py)",
    "flash_attention_bwd_dkdv": "none (XLA's fusion of src/repro/models/attention.py)",
    "flash_attention_bwd_dq": "none (XLA's fusion of src/repro/models/attention.py)",
    "rglru_scan": "src/repro/kernels/rglru_scan/kernel.py:55",
    "mamba_scan": "src/repro/kernels/mamba_scan/kernel.py:63",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:75",
    # the route of matern52_gram_pallas inside the jitted chain
    # (src/repro/core/gp/slice_sampler.py:109, fit.py:25)
    "slice_chain": "src/repro/kernels/matern52/kernel.py:148",
    "ssd_pack": "none: the JAX package has no Mamba-2 mixer",
    "ssd_fwd": "none: the JAX package has no Mamba-2 mixer",
    "ssd_bwd": "none: the JAX package has no Mamba-2 mixer",
}
SOURCES = {
    "acq_score": "src/repro_torch/kernels/csrc/acq_score.cu",
    "acq_score_multi": "src/repro_torch/kernels/csrc/acq_score_multi.cu",
    "matern52_gram": "src/repro_torch/kernels/csrc/matern52.cu",
    "matern52_cross": "src/repro_torch/kernels/csrc/matern52.cu",
    "matern52_operand": "src/repro_torch/kernels/csrc/matern52.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_bwd_dot": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    "flash_attention_bwd_dkdv": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    "flash_attention_bwd_dq": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    "rglru_scan": "src/repro_torch/kernels/csrc/rglru_scan.cu",
    "mamba_scan": "src/repro_torch/kernels/csrc/mamba_scan.cu",
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "slice_chain": "src/repro_torch/kernels/csrc/slice_chain.cu",
    "ssd_pack": "src/repro_torch/kernels/csrc/ssd.cu",
    "ssd_fwd": "src/repro_torch/kernels/csrc/ssd.cu",
    "ssd_bwd": "src/repro_torch/kernels/csrc/ssd.cu",
}
# The path whose launches the JSON line reports for each kernel.
PATH_OF = {"acq_score": "main", "acq_score_multi": "multi",
           "matern52_gram": "kb", "matern52_cross": "main", "matern52_operand": "main",
           "flash_attention": "serve", "rglru_scan": "serve",
           "flash_attention_bwd_dot": "train", "flash_attention_bwd_dkdv": "train",
           "flash_attention_bwd_dq": "train",
           "mamba_scan": "mamba", "decode_attention": "decode_check",
           "slice_chain": "main", "ssd_pack": "hybrid", "ssd_fwd": "hybrid",
           "ssd_bwd": "hybrid"}

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
# flash_attention, decode_attention, rglru_scan and mamba_scan: the
# reference's own Pallas tolerances (tests/test_kernels.py) — 3e-5 in f32 for
# attention, 1e-4 for the scans (1e-3 for rglru's extreme decays, passed to
# ``check`` by that case).
TOL = {("acq_score", "f64"): 1e-9, ("acq_score", "f32"): 2e-2,
       ("acq_score_multi", "f64"): 1e-9, ("acq_score_multi", "f32"): 2e-2,
       ("matern52_gram", "f32"): 2e-5, ("matern52_cross", "f32"): 2e-5,
       ("matern52_operand", "f32"): 2e-5,
       ("flash_attention", "f32"): 3e-5, ("rglru_scan", "f32"): 1e-4,
       ("decode_attention", "f32"): 3e-5, ("mamba_scan", "f32"): 1e-4}
# Held per element instead, as |Δ| ≤ rel·|plain| + abs: bf16 attention.
# The plain version keeps the probabilities P in f32; the kernels' tensor-
# core bodies feed P to the bf16 MMA as two bf16 parts, hi = bf16(p) and
# lo = bf16(p − hi), which keep ~16 of P's bits (P rounded once to bf16,
# 8 bits, moves the output of rows over few keys past this bound:
# ``python tests/test_torch_lm_kernels.py`` shows it at the serving shape's
# band), and accumulate in f32. So both sides agree to ~2^-16 of the value
# before each rounds once to bf16, and differ by at most one bf16 ulp of
# the value (≤ 2^-7·|plain|) plus noise near zero (2^-9 covers it many
# times over). One limit relative to the largest output would not do: the
# few early rows, over few keys, set a maximum near 3, while the rows that
# average ~2048 keys spread only ~0.04 around 0.
TOL_ELEM = {("flash_attention", "bf16"): (2.0**-7, 2.0**-9),
            ("decode_attention", "bf16"): (2.0**-7, 2.0**-9)}
# Serve path (phase 6), kernels vs the plain torch composition on the same
# weights and requests, as max |Δ| over max(1, max |plain|). The torch path
# rounds the attention probabilities P to bf16 once before P·V (as the JAX
# package's XLA path does); the kernel rounds P to bf16 too, but as two
# parts, hi + lo, that together keep ~16 bits. So the torch path's single
# rounding moves each of the 12 attention layers' outputs by about one bf16
# ulp (2^-8) of their size against the kernel's, and the bf16 residual
# stream carries every layer's move on to the logits, the states and the
# caches after it: 12 · 2^-8 ≈ 4.7e-2.
SERVE_TOL = 5e-2
# Phase 7 (falcon-mamba-7b) in bf16. It has no attention, so its kernel and
# torch composition differ only where two f32 sums ~1e-7 apart round to
# different bf16 values, but its 64 random-weight layers grow such one-ulp
# moves: the first chip runs of this phase measured 2.737e-2 for decode
# after prefill (both sides compute the same function) and 5.507e-2 for the
# torch composition, past the 2e-2 bound set before them. The same checks
# in float32 (the weights' own type, rounding 2^16 times finer) measured at
# most 1.487e-5, so the semantics agree and the bf16 gap is rounding noise.
# Phase 7 therefore holds the float32 checks at 1e-3, far above their noise
# and far below any slip of semantics (a cast, a cache, a step), and the
# bf16 ones at 1e-1, about twice the noise measured, against breakage.
MAMBA_BF16_TOL = 1e-1
F32_SERVE_TOL = 1e-3
# Phase 10 (granite-moe-1b-a400m) in bf16, the torch composition taking the
# kernel run's expert choices (MoERouting; left to its own, it chooses
# another top-8 set at ~4% of (layer, token) routings, each a jump of its
# token's output). The first chip run of this phase measured at most
# 1.717e-2 (the KV caches; logits 9.4e-3 to 1.12e-2, decode after prefill
# 1.121e-2), where one bf16 ulp per attention layer over 24 layers allows
# 24 · 2^-8 ≈ 9.4e-2. The bound is 5e-2, about three times the measurement,
# against breakage; the float32 checks (F32_SERVE_TOL) hold the semantics.
GRANITE_BF16_TOL = 5e-2
# slice_chain against its plain version (phase 2): the kept samples to
# 1e-9 — both sides compute the chain's points with the same float64
# operations, so while they take the same branches the samples are equal,
# and 1e-9 leaves room only for that. A branch may differ where the two log
# densities (an in-block Cholesky against cuSOLVER's) straddle the slice
# level: that is a near-tie when |g − log_y| ≤ 1e-9·max(1, |log_y|) on both
# sides; at most one chain of the thirteen may end on one.
CHAIN_TOL = 1e-9
CHAIN_TIE = 1e-9
CHAIN_MAX_TIES = 1

# Phase 12, the SSD pair against the composition in float32 on the same
# bf16 inputs, as gaps of norms (tests/test_torch_ssd_kernel.py's limits):
# y 5e-3, since every product takes bf16 operands (2^-9 relative each)
# with float32 accumulation, a few 2^-9 over √(terms); the five gradients
# 1e-2, since the backward's products take bf16 operands too and dx, dB
# and dC are bf16.
SSD_TOL = {"y": 5e-3, "grad": 1e-2}


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


def sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


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


def bound_parts(nbytes: float, flops: dict, peaks) -> tuple:
    """The two least times for the work, in ms: bytes over the HBM rate, and
    the operations, each over the peak of the units that can run them
    (``flops`` maps a PEAKS key to a FLOP count)."""
    return (nbytes / peaks["hbm"] * 1e3,
            sum(f / peaks[unit] for unit, f in flops.items()) * 1e3)


def bound_ms(nbytes: float, flops: dict, peaks) -> tuple:
    """Least time for the work: the larger of the two ``bound_parts``."""
    t_bytes, t_ops = bound_parts(nbytes, flops, peaks)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_done(label: str, t0: float) -> None:
    print(f"phase {label}: {time.perf_counter() - t0:.1f} s", flush=True)


# Phases 6–7: the served models, their requests and the seed of weights and
# data. Parameter counts are the JAX package's Model.abstract_params counts.
SERVE_ARCH = "recurrentgemma-9b"
SERVE_PARAMS = 7_483_805_696
MAMBA_ARCH = "falcon-mamba-7b"
MAMBA_PARAMS = 7_272_665_088
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 3000, 16
SERVE_SEED = 2024
# Phase 10: granite-moe-1b-a400m at its published widths and depth; its
# training run (the launcher's data at seq 1024, global batch 16) and the
# tuning job (the launcher's seq 64 and global batch 8).
GRANITE_ARCH = "granite-moe-1b-a400m"
GRANITE_PARAMS = 1_334_628_352
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 1024, 16, 10
TUNE_TRIALS, TUNE_STEPS, TUNE_EVERY = 8, 60, 10
# Phase 11: granite's training through the (1, 1) mesh — steps held bit
# for bit, then steps timed — and the production-mesh dry-run's cells. The
# dry-run's per-device peak estimate must come within ESTIMATE_TOL of the
# card's max_memory_allocated for the same step.
MESH_TRAIN_STEPS, MESH_TIMED_STEPS = 3, 3
# Phase 12: the hybrid arch whose Mamba-2 mixers run the SSD pair.
HYBRID_ARCH = "granite-4.0-h-small"
DRYRUN_ARCH = "qwen3-moe-235b-a22b"
DRYRUN_SHAPES = ("train_4k", "decode_32k")
DRYRUN_TIMEOUT = 400.0
ESTIMATE_TOL = 0.25


def band_pairs(s: int, window: int) -> int:
    """Live (query, key) pairs of one head's causal band over s positions."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def device_profile(torch, label, fn, top=8) -> None:
    """Run ``fn`` once under ``torch.profiler``; print the device's busy
    time (the union of the intervals of the device's own activities —
    kernels, copies, sets — leaving out the synchronisation records) against
    the wall time, and the kernels that took most of it. Host-side entries
    (``aten::`` ops, runtime calls, profiler overhead) carry the time of the
    kernels they launch and are not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or "Sync" in e.name or "Wait" in e.name:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (end - start) / 1e3, count + 1)
    busy_us, reach = 0.0, -math.inf
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    busy_ms = busy_us / 1e3
    print(f"profile {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"(idle share {1.0 - busy_ms / wall_ms:.3f}), {len(spans)} device activities",
          flush=True)
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {ms:10.3f} ms {ms / max(busy_ms, 1e-9):6.1%} x{count:<5d} {name[:100]}",
              flush=True)


def chain_divergence(tk, tp, levels):
    """The first evaluation at which two chains' traces — rows (update, g),
    in order — decide a branch differently, as (evaluation, update, near-
    tie?), or None when they decide every branch alike. Each update's first
    evaluation is g(0), which sets its slice level g(0) − level; a trace
    whose updates fall out of step before any branch differs is a fault
    (tie False)."""
    lk = lp = None
    for e in range(min(len(tk), len(tp))):
        (uk, gk), (up, gp) = tk[e], tp[e]
        if uk != up:
            return e, int(up), False
        if e == 0 or tk[e - 1][0] != uk:
            lk, lp = gk - levels[int(uk)], gp - levels[int(up)]
            continue
        if (gk > lk) != (gp > lp):
            tie = all(abs(g - lv) <= CHAIN_TIE * max(1.0, abs(lv))
                      for g, lv in ((gk, lk), (gp, lp)))
            return e, int(uk), tie
    if len(tk) != len(tp):
        return min(len(tk), len(tp)), -1, False
    return None


def rel_err(got, ref) -> float:
    """max |got − ref| over max(1, max |ref|), in f32."""
    return float((got.float() - ref.float()).abs().max()) / max(1.0, float(ref.float().abs().max()))


def clone_caches(caches):
    return [tuple(t.clone() for t in c) if isinstance(c, tuple)
            else {key: t.clone() for key, t in c.items()} for c in caches]


def cache_errs(errs: dict, got, ref, suffix: str = "") -> None:
    """Fold the largest ``rel_err`` of each kind of cache leaf (KV caches,
    or a recurrent cache's ``conv``, ``h``, ``ssm``) into ``errs``."""
    for g_cache, r_cache in zip(got, ref):
        pairs = (zip(("kv caches", "kv caches"), g_cache, r_cache) if isinstance(r_cache, tuple)
                 else ((f"{key} states", g_cache[key], r_cache[key]) for key in r_cache))
        for leaf, g_, r_ in pairs:
            errs[leaf + suffix] = max(errs.get(leaf + suffix, 0.0), rel_err(g_, r_))


def serve_model(torch, K, arch, n_expected, expect, tol, dev, f32_tol=None, routing=None):
    """Serve ``SERVE_BATCH`` seeded ``SERVE_PROMPT``-token requests of
    ``arch`` at its full published widths and depth (seeded weights made on
    the card) for ``SERVE_NEW`` greedy tokens with the kernels; fail unless
    the run launched exactly ``expect`` (kernel → count, one prefill). Then
    time it step by step, profile one decode step and one prefill, time the
    weight casts, hold decode after prefill against the forward one token
    longer, and run the same requests through the plain torch composition,
    teacher-forced with the kernel run's tokens: prefill logits, every cache
    leaf and the decode logits within ``tol`` of max(1, max |torch|). With
    ``f32_tol``, then the same in float32: decode after prefill against the
    forward one token longer, and the prefill's logits and caches against
    the torch composition's. Returns (the serving run's launch counts, the
    model, its caches right after the prefill, {"prefill_ms", "step_ms"}:
    the timed prefill and the median decode step)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import rms_norm
    from repro_torch.training import greedy_generate, make_decode_step, make_prefill

    cfg = get_config(arch)
    B, S, NEW = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    t0 = time.perf_counter()
    model = build_model(cfg, impl="kernel").init(SERVE_SEED)
    torch.cuda.synchronize()
    n_params = model.num_params()
    kinds = ", ".join(f"{model.kinds.count(k)} {k}" for k in sorted(set(model.kinds)))
    print(f"serve: {arch}, {len(model.kinds)} layers ({kinds}), {n_params} parameters "
          f"({n_params * 4 / 1e9:.2f} GB f32), init {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated", flush=True)
    if n_params != n_expected:
        fail(f"serve: {n_params} parameters, the JAX package counts {n_expected}")
    cache_len = S + NEW
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)

    # the main path: greedy_generate with the kernels, counts from 0
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tokens = greedy_generate(model, prompt, NEW, cache_len)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    print(f"serve: greedy_generate of {B} x {S}-token prompts, {NEW} new tokens each, "
          f"in {wall:.3f} s; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"launches {launches}", flush=True)
    for kname in K.KERNEL_NAMES:
        if launches[kname] != expect.get(kname, 0):
            fail(f"serve: {launches[kname]} {kname} launches, expected "
                 f"{expect.get(kname, 0)} (one prefill)")
    if tuple(tokens.shape) != (B, NEW) or int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab_size:
        fail(f"serve: tokens of shape {tuple(tokens.shape)} outside the vocabulary")

    # the same requests timed step by step (prefill, then each decode step)
    prefill = make_prefill(model, cache_len)
    step = make_decode_step(model)
    with routing.recording() if routing else contextlib.nullcontext():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill(prompt)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        if tuple(logits.shape) != (B, cfg.vocab_size) or not torch.isfinite(logits).all():
            fail("serve: prefill logits not finite or of the wrong shape")
        snapshot = clone_caches(caches)
        k_logits = [logits]
        step_ms = []
        for i in range(NEW):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = step(caches, tokens[:, i], S + i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if not torch.isfinite(logits).all():
                fail(f"serve: decode step {i} logits not finite")
            k_logits.append(logits)
    # where a step's and a prefill's time goes (one more of each)
    device_profile(torch, "decode step", lambda: step(caches, tokens[:, -1], S + NEW))
    del caches
    device_profile(torch, "prefill", lambda: prefill(prompt))
    if not all(torch.equal(k_logits[i].argmax(-1), tokens[:, i]) for i in range(NEW)):
        fail("serve: the timed pass picked other tokens than greedy_generate")
    step_med = statistics.median(step_ms)

    def cast_all():
        for p in model.parameters():
            p.to(torch.bfloat16)

    cast_ms = time_ms(torch, cast_all, reps=5, warmup=1, hide_host=False)
    # a decode step casts every block weight once, and the embedding twice
    # when it is tied (input and head)
    extra = model.embed if cfg.tie_embeddings else None
    extra_ms = time_ms(torch, lambda: extra.to(torch.bfloat16), reps=5, warmup=1) if extra is not None else 0.0
    print(f"serve: prefill {prefill_ms:.3f} ms ({B * S * 1e3 / prefill_ms:.1f} prompt "
          f"tokens/s); decode per step median {step_med:.3f} ms, min {min(step_ms):.3f}, "
          f"max {max(step_ms):.3f} ({B * 1e3 / step_med:.1f} tokens/s over {B} requests); "
          f"whole generation {prefill_ms + sum(step_ms):.3f} ms", flush=True)
    tied = (f"the tied embedding alone {extra_ms:.3f} ms, cast twice a step"
            if extra is not None else "no tied embedding")
    print(f"serve: casting every f32 weight to bf16 once takes {cast_ms:.3f} ms "
          f"({tied}); a decode step's casts take about {cast_ms + extra_ms:.3f} ms "
          f"of its {step_med:.3f} ms", flush=True)

    # decode after prefill equals the full forward one token longer
    with routing.no_drop(model) if routing else contextlib.nullcontext():
        with torch.inference_mode():
            full = torch.cat([prompt, tokens[:, :1]], dim=1)
            x, _ = model._backbone(model._embed(full), model._positions(B, S + 1))
            x = rms_norm(x, model.final_norm, cfg.norm_eps)
            want = model._head(x[:, -1:, :]).float()[:, 0]
            del full, x
        if routing:
            _, parity_caches = prefill(prompt)
            first, _ = step(parity_caches, tokens[:, 0], S)
            del parity_caches
        else:
            first = k_logits[1]
    rel = float((first - want).abs().max()) / max(1.0, float(want.abs().max()))
    print(f"serve: decode after prefill vs the forward over S+1 tokens: max |Δ| "
          f"{rel:.3e} of max(1, max |logit|) (tol {tol:.0e})", flush=True)
    if rel > tol:
        fail("serve: decode after prefill disagrees with the full forward")

    # invariance: the plain torch composition, teacher-forced with the
    # kernel run's tokens
    model.impl = "torch"
    K.reset_launch_counts()
    with routing.replaying() if routing else contextlib.nullcontext():
        t0 = time.perf_counter()
        logits, caches = prefill(prompt)
        torch.cuda.synchronize()
        torch_prefill_ms = (time.perf_counter() - t0) * 1e3
        if any(K.LAUNCHES.values()):
            fail(f"serve: the torch composition launched kernels {dict(K.LAUNCHES)}")
        errs = {"prefill logits": rel_err(logits, k_logits[0])}
        cache_errs(errs, caches, snapshot)
        errs["decode logits"] = 0.0
        top1 = int((logits.argmax(-1) == k_logits[0].argmax(-1)).sum())
        for i in range(NEW):
            logits, caches = step(caches, tokens[:, i], S + i)
            errs["decode logits"] = max(errs["decode logits"], rel_err(logits, k_logits[i + 1]))
            top1 += int((logits.argmax(-1) == k_logits[i + 1].argmax(-1)).sum())
    model.impl = "kernel"
    print(f"serve invariance (kernels vs torch composition, teacher-forced): torch prefill "
          f"{torch_prefill_ms:.3f} ms; max |Δ| over max(1, max |torch|): "
          + ", ".join(f"{key} {val:.3e}" for key, val in errs.items())
          + f" (tol {tol:.0e}); top-1 agreement {top1} of {B * (NEW + 1)}"
          + (f"; {routing.summary()}" if routing else ""), flush=True)
    if max(errs.values()) > tol:
        fail("serve: the kernels and the torch composition disagree")
    del caches, k_logits
    if f32_tol is not None:
        f32_checks(torch, K, model, prompt, tokens, f32_tol, routing)
    return launches, model, snapshot, {"prefill_ms": prefill_ms, "step_ms": step_med}


def f32_checks(torch, K, model, prompt, tokens, tol, routing=None) -> None:
    """``serve_model``'s decode-after-prefill and kernel-vs-torch checks with
    the model computing in float32 (its weights' type, so no casts); a MoE
    model with a capacity that drops no pair, the torch composition taking
    the kernel prefill's expert choices."""
    from repro_torch.models.common import rms_norm

    cfg = model.cfg
    B, S = prompt.shape
    bf16 = model.compute_dtype
    model.compute_dtype = torch.float32
    t0 = time.perf_counter()
    with routing.no_drop(model) if routing else contextlib.nullcontext():
        with torch.inference_mode():
            full = torch.cat([prompt, tokens[:, :1]], dim=1)
            x, _ = model._backbone(model._embed(full), model._positions(B, S + 1))
            x = rms_norm(x, model.final_norm, cfg.norm_eps)
            want = model._head(x[:, -1:, :]).float()[:, 0]
            del full, x
        with routing.recording() if routing else contextlib.nullcontext():
            logits, caches = model.prefill(prompt, S + 1)
        snapshot = clone_caches(caches)
        stepped, _ = model.decode_step(caches, tokens[:, 0], S)
        del caches
        errs = {"decode after prefill vs forward": rel_err(stepped, want)}
        model.impl = "torch"
        with routing.replaying() if routing else contextlib.nullcontext():
            t_logits, t_caches = model.prefill(prompt, S + 1)
    model.impl = "kernel"
    model.compute_dtype = bf16
    errs["prefill logits vs torch"] = rel_err(logits, t_logits)
    cache_errs(errs, t_caches, snapshot, " vs torch")
    torch.cuda.synchronize()
    print(f"serve f32 (compute in float32, {time.perf_counter() - t0:.1f} s): max |Δ| over "
          "max(1, max |ref|): " + ", ".join(f"{key} {val:.3e}" for key, val in errs.items())
          + f" (tol {tol:.0e})" + (f"; {routing.summary()}" if routing else ""), flush=True)
    if max(errs.values()) > tol:
        fail("serve f32: decode after prefill or the torch composition disagrees")


class MoERouting:
    """Instrumentation of the port's MoE routing (``models/mlp.py::route``)
    for the serving checks of a MoE model. While ``recording``, each routing
    call's top-k experts are kept in call order (the kernel run); while
    ``replaying``, each call takes the recorded experts instead of its own —
    the torch composition then routes as the kernel run did, so the logits
    and caches compare the kernels and not two routings — and the tokens
    whose own top-k set differs are counted (a numerical difference moving a
    near-tie across the k-th place). ``no_drop`` runs a block with a
    capacity that drops no pair."""

    def __init__(self, torch):
        from repro_torch.models import mlp

        self.torch, self.mlp, self.own = torch, mlp, mlp.route
        self.mode, self.calls, self.at = None, [], 0
        self.flips = self.tokens = 0
        mlp.route = self._route

    def close(self) -> None:
        self.mlp.route = self.own

    def _route(self, probs, k, capacity):
        torch = self.torch
        out = self.own(probs, k, capacity)
        if self.mode == "record":
            self.calls.append(out[1])
        elif self.mode == "replay":
            want = self.calls[self.at]
            self.at += 1
            same = torch.sort(out[1], -1).values == torch.sort(want, -1).values
            self.flips += int((~same.all(-1)).sum())
            self.tokens += same[..., 0].numel()
            # the slots of the recorded choices: rank them k…1, the rest 0
            ranks = torch.arange(k, 0, -1, dtype=probs.dtype, device=probs.device)
            fake = torch.zeros_like(probs).scatter_(-1, want, ranks.expand_as(want).contiguous())
            _, _, pos, keep = self.own(fake, k, capacity)
            top_p = torch.gather(probs, -1, want)
            top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
            return top_p, want, pos, keep
        return out

    @contextlib.contextmanager
    def recording(self):
        self.mode, self.calls = "record", []
        try:
            yield
        finally:
            self.mode = None

    @contextlib.contextmanager
    def replaying(self):
        self.mode, self.at, self.flips, self.tokens = "replay", 0, 0, 0
        try:
            yield
        finally:
            self.mode = None
        if self.at != len(self.calls):
            fail(f"MoE replay took {self.at} routing calls of {len(self.calls)} recorded")

    @contextlib.contextmanager
    def no_drop(self, model):
        cfg = model.cfg
        moe = dataclasses.replace(cfg.moe, capacity_factor=float(
            cfg.moe.num_experts / cfg.moe.top_k) + 1.0)
        model.cfg = dataclasses.replace(cfg, moe=moe)
        try:
            yield
        finally:
            model.cfg = cfg

    def summary(self) -> str:
        return (f"expert sets the torch composition would choose otherwise: {self.flips} "
                f"of {self.tokens} (layer, token) routings ({self.flips / max(self.tokens, 1):.3%});"
                " it takes the kernel run's")


def serve_phase(torch, np, K, check, peaks, dev) -> tuple:
    """Phase 6; returns the serving run's launch counts and those of the
    flash-decode run on its caches."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.plain import decode_attention_plain
    from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
    from repro_torch.kernels.flash_attention.plain import band_mask, flash_attention_plain
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_kernel
    from repro_torch.kernels.rglru_scan.plain import rglru_scan_plain
    from repro_torch.models.attention import slot_valid

    cfg = get_config(SERVE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    B, S = SERVE_BATCH, SERVE_PROMPT

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # flash_attention: the serving shape (bf16, MQA, Dh 256, window 2048, a
    # prompt that is not a multiple of the tile), the same in f32 at one
    # request (the second float4 group of a lane, Dh 128–255, and the band's
    # edge held at 3e-5), then the JAX package's sweep (tests/test_kernels.py)
    # in f32 and its dtype case in both types. Then the bf16 tensor-core body
    # at each (G, Dh, window) of the registry's attention archs, prompts
    # ragged against its 128-row blocks and 64-key tiles: recurrentgemma (16,
    # 256, 2048), h2o-danube3 (4, 120 — padded to 128 in shared memory —
    # 4096), qwen2.5 (8, 128, global), gemma3 (2, 128, 1024 and global),
    # minitron (3, 128, global), internvl2 (7, 64, global), musicgen (1, 64,
    # global); one soft-capped case; and windows of 1, 9 and 40, inside one
    # tile.
    # Bound: 4·Dh FLOPs per live pair of the band at the inputs' type's
    # peak (bf16 tensor cores; f32 outside them) against q/k/v/o bytes.
    flash_cases = [(B, S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.window,
                    0.0, torch.bfloat16, True),
                   (1, S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.window,
                    0.0, torch.float32, False)]
    flash_cases += [c + (torch.float32, False) for c in (
        (2, 128, 4, 2, 64, 0, 0.0), (1, 256, 8, 1, 128, 0, 0.0),
        (2, 384, 6, 2, 80, 100, 0.0), (1, 200, 2, 2, 64, 0, 0.0),
        (2, 256, 4, 2, 64, 0, 30.0), (1, 130, 4, 4, 96, 64, 20.0),
        (2, 200, 4, 2, 120, 0, 0.0))]
    flash_cases += [(1, 256, 4, 2, 128, 0, 0.0, tdt, False)
                    for tdt in (torch.bfloat16, torch.float32)]
    flash_cases += [c + (torch.bfloat16, False) for c in (
        (1, 2000, 16, 1, 256, 2048, 0.0), (2, 1000, 8, 2, 120, 4096, 0.0),
        (1, 1900, 16, 2, 128, 0, 0.0), (1, 1700, 8, 4, 128, 1024, 0.0),
        (2, 1100, 4, 2, 128, 0, 0.0), (1, 1300, 6, 2, 128, 0, 0.0),
        (2, 1200, 14, 2, 64, 0, 0.0), (1, 1800, 4, 4, 64, 0, 0.0),
        (1, 1000, 8, 4, 128, 1024, 50.0),
        (2, 1000, 8, 2, 64, 1, 0.0), (2, 1000, 8, 2, 64, 9, 0.0), (2, 1000, 8, 2, 64, 40, 0.0))]
    for b, s, hq, hkv, dh, window, cap, tdt, main in flash_cases:
        q, k, v = (randn(b, s, h, dh).to(tdt) for h in (hq, hkv, hkv))
        dt, es = ("bf16", 2) if tdt == torch.bfloat16 else ("f32", 4)
        nbytes = es * (2 * b * s * hq * dh + 2 * b * s * hkv * dh)
        flops = {dt: 4 * dh * b * hq * band_pairs(s, window)}
        library = None
        if main:
            # the yardstick: one SDPA call with the band as a boolean mask
            mask = band_mask(s, window, dev)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True).transpose(1, 2)
        check("flash_attention", dt,
              f"B={b} S={s} Hq={hq} Hkv={hkv} Dh={dh} window={window} softcap={cap}",
              lambda: flash_attention_kernel(q, k, v, window, cap),
              lambda: flash_attention_plain(q, k, v, window, cap),
              nbytes, flops, main_shape=main, library=library)
        del q, k, v, library

    # training's flash-attention pair at granite-moe-1b-a400m's train16k and
    # train32k microbatches (8 / 16 x 1024, 16/8 heads of 64),
    # granite-4.0-h-small's attention (1 x 4096, 32/8 heads of 128, scale
    # 1/128), recurrentgemma-9b's local attention (1 x 4096, 16/1 heads of
    # 256, window 2048) and a ragged, windowed, soft-capped case:
    # * the forward with the row LSE against the plain forward: O per
    #   element as above, the LSE to 5e-5 absolute (f32 sums in another
    #   order, ex2.approx);
    # * the backward's three kernels against the plain backward, f32 on the
    #   same bf16 inputs, from the plain forward's LSE and the kernel's O
    #   (which D reads): D to 1e-5 of its norm; dK, dV and dQ to 1e-2 of
    #   their norms, since P and dS enter their MMAs as bf16 and the outputs
    #   are bf16 (tests/test_torch_flash_train.py holds them alike);
    # * the pair's forward and backward through autograd beside the
    #   composition training ran before it (``_attend`` with the route
    #   turned off), timed only.
    # Bounds: the forward 4·Dh FLOPs a live pair; D reads o and do once and
    # writes D (bytes); the gradient needs 10·Dh a live pair (S, dP, dV, dK
    # and dQ once), of which dK/dV does 8·Dh and dQ 2·Dh — dQ's second S and
    # dP (4·Dh) are the design's overhead, outside its bound.
    import types

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd_lse
    from repro_torch.kernels.flash_attention.plain import flash_attention_bwd_plain
    from repro_torch.kernels.flash_attention.train import FlashAttentionTrain
    from repro_torch.models import attention
    from repro_torch.models.common import NO_MESH

    bwd_lib = _build.library("flash_attention_bwd")
    for b, s, hq, hkv, dh, window, cap, scale, main in (
            (8, 1024, 16, 8, 64, 0, 0.0, 0.125, True),
            (16, 1024, 16, 8, 64, 0, 0.0, 0.125, False),
            (1, 4096, 32, 8, 128, 0, 0.0, 1 / 128, False),
            (1, 4096, 16, 1, 256, 2048, 0.0, 0.0625, False),
            (2, 300, 6, 2, 96, 100, 30.0, 96**-0.5, False)):
        q, k, v, do = (randn(b, s, h, dh).bfloat16() for h in (hq, hkv, hkv, hq))
        pairs = b * hq * band_pairs(s, window)
        label = f"B={b} S={s} Hq={hq} Hkv={hkv} Dh={dh} window={window} softcap={cap}"
        qkv_bytes = 2 * (2 * b * s * hq * dh + 2 * b * s * hkv * dh)
        def plain_fwd():
            return flash_attention_plain(q, k, v, window, cap, scale, lse=True)

        for i, part in enumerate(("O", "LSE")):
            check("flash_attention", "bf16", f"{label} scale={scale:.6g} {part}",
                  lambda i=i: flash_attention_fwd_lse(q, k, v, window, cap, scale)[i],
                  lambda i=i: plain_fwd()[i], qkv_bytes + 4 * b * hq * s,
                  {"bf16": 4 * dh * pairs}, main_shape=False,
                  **({} if part == "O" else dict(tol=5e-5, measure="abs")))
        o, lse = flash_attention_fwd_lse(q, k, v, window, cap, scale)
        want_lse = plain_fwd()[1]

        def plain_bwd():
            return flash_attention_bwd_plain(*(x.float() for x in (q, k, v, o)), want_lse,
                                             do.float(), window, cap, scale)
        delta = torch.empty((b, hq, s), dtype=torch.float32, device=dev)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        sizes = (b, s, hq, hkv, dh, window, cap, scale)
        ptr = {n: x.data_ptr() for n, x in dict(q=q, k=k, v=v, o=o, do=do, lse=lse,
                                                 delta=delta, dq=dq, dk=dk, dv=dv).items()}
        stream = torch.cuda.current_stream().cuda_stream

        def dot():
            bwd_lib.flash_attention_bwd_dot_bf16(ptr["o"], ptr["do"], ptr["delta"], b, s, hq,
                                                 dh, stream)
            return delta

        def dkdv(out):
            bwd_lib.flash_attention_bwd_dkdv_bf16(
                ptr["q"], ptr["k"], ptr["v"], ptr["do"], ptr["lse"], ptr["delta"], ptr["dk"],
                ptr["dv"], *sizes, stream)
            return out

        def dqk():
            bwd_lib.flash_attention_bwd_dq_bf16(
                ptr["q"], ptr["k"], ptr["v"], ptr["do"], ptr["lse"], ptr["delta"], ptr["dq"],
                *sizes, stream)
            return dq

        want_delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1)
        check("flash_attention_bwd_dot", "bf16", label, dot, lambda: want_delta,
              4 * b * s * hq * dh + 4 * b * hq * s, {"f32": 2 * b * s * hq * dh},
              main_shape=main, tol=1e-5, measure="norm")
        dot()
        dkdv_bytes = 2 * (3 * b * s * hq * dh + 4 * b * s * hkv * dh) + 8 * b * hq * s
        for i, name, got in ((1, "dK", dk), (2, "dV", dv)):
            check("flash_attention_bwd_dkdv", "bf16", f"{label} {name}",
                  lambda got=got: dkdv(got), lambda i=i: plain_bwd()[i], dkdv_bytes,
                  {"bf16": 8 * dh * pairs}, main_shape=main, tol=1e-2, measure="norm")
        check("flash_attention_bwd_dq", "bf16", f"{label} dQ", dqk, lambda: plain_bwd()[0],
              2 * (3 * b * s * hq * dh + 2 * b * s * hkv * dh) + 8 * b * hq * s,
              {"bf16": 2 * dh * pairs}, main_shape=main, tol=1e-2, measure="norm")
        del want_lse, delta, dq, dk, dv, o, lse
        if cap == 0.0:
            qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
            cfg_t = types.SimpleNamespace(attn_scale=scale, attn_softcap=cap)
            pos = torch.arange(s, device=dev)[None].expand(b, s)

            def pair_step():
                out = FlashAttentionTrain.apply(qg, kg, vg, window, cap, scale)
                torch.autograd.grad(out, (qg, kg, vg), do)

            def comp_fwd():
                return attention._attend(qg, kg, vg, pos, cfg_t, window, "torch", 1024,
                                         NO_MESH)

            def comp_step():
                torch.autograd.grad(comp_fwd(), (qg, kg, vg), do)

            pair_ms = time_ms(torch, pair_step, reps=10)
            route = attention._train_route
            attention._train_route = lambda q: False  # the composition
            try:
                comp_ms = time_ms(torch, comp_fwd, reps=10)
                comp_step_ms = time_ms(torch, comp_step, reps=10)
            finally:
                attention._train_route = route
            print(f"flash_attention_train bf16 {label}: the pair forward + backward "
                  f"{pair_ms:.5f} ms ({14 * dh * pairs / pair_ms / 1e9:.2f} TFLOP/s of the "
                  f"4·Dh + 10·Dh a pair they need); the composition it replaced: forward "
                  f"{comp_ms:.5f} ms, forward + backward {comp_step_ms:.5f} ms", flush=True)
            del qg, kg, vg
        del q, k, v, do
        torch.cuda.empty_cache()

    # rglru_scan: the serving shape (B, S, d_inner), the JAX package's sweep
    # and its extreme-decay case. Bound: 12 bytes per element (a, g read, h
    # written) plus the last state, at the HBM rate.
    rg_cases = [(B, S, cfg.rglru.d_inner, False, True),
                (2, 64, 128, False, False), (1, 500, 256, False, False),
                (2, 129, 300, False, False), (1, 384, 256, True, False)]
    for b, s, di, extreme, main in rg_cases:
        if extreme:
            a = torch.cat([torch.full((b, s, di // 2), 0.9999, device=dev),
                           torch.full((b, s, di // 2), 1e-4, device=dev)], dim=-1)
        else:
            a = 0.01 + (0.9999 - 0.01) * torch.rand((b, s, di), generator=gen, device=dev)
        g = randn(b, s, di)
        h, h_last = rglru_scan_kernel(a, g)
        torch.cuda.synchronize()
        if not torch.equal(h_last, h[:, -1]):
            fail(f"rglru_scan (B={b} S={s} di={di}): last state is not h[:, -1]")
        check("rglru_scan", "f32", f"B={b} S={s} di={di}" + (" extreme decays" if extreme else ""),
              lambda: rglru_scan_kernel(a, g)[0], lambda: rglru_scan_plain(a, g)[0],
              4 * (3 * b * s * di + b * di), {"f32": 2 * b * s * di}, main_shape=main,
              tol=1e-3 if extreme else None)
        del a, g, h, h_last
    torch.cuda.empty_cache()

    launches, model, snapshot, _ = serve_model(
        torch, K, SERVE_ARCH, SERVE_PARAMS,
        {"flash_attention": cfg.layer_kinds().count("swa"),
         "rglru_scan": cfg.layer_kinds().count("rglru")}, SERVE_TOL, dev)

    # decode_attention, which no model calls (as in the JAX package): its
    # path of its own is one flash-decode per swa layer on the real ring
    # caches the prefill built (4 × 3000 tokens: the 2048-slot rings have
    # wrapped), at decode time t = 3000 with the mask attention_decode
    # builds there, through the public entry point; counts from 0.
    hq, dh, t_dec = cfg.num_heads, cfg.head_dim, S
    swa = [c for c, kind in zip(snapshot, model.kinds) if kind == "swa"]
    q_dec = randn(B, hq, dh).to(swa[0][0].dtype)  # the compute dtype, bf16
    ring_valid = slot_valid(swa[0][0].shape[1], t_dec, cfg.window, dev)
    ring_valid = ring_valid[None, :].expand(B, -1).contiguous()
    K.reset_launch_counts()
    outs = [decode_attention(q_dec, k, v, ring_valid) for k, v in swa]
    torch.cuda.synchronize()
    decode_launches = dict(K.LAUNCHES)
    print(f"decode check: decode_attention on the {len(swa)} swa layers' ring caches at "
          f"t={t_dec} ({int(ring_valid[0].sum())} of {ring_valid.shape[1]} slots valid); "
          f"launches {decode_launches}", flush=True)
    if decode_launches["decode_attention"] != len(swa) or any(
            n for kname, n in decode_launches.items() if kname != "decode_attention"):
        fail(f"decode check: launches {decode_launches}, expected {len(swa)} decode_attention")
    if not all(torch.isfinite(o).all() and o.shape == q_dec.shape for o in outs):
        fail("decode check: outputs not finite or of the wrong shape")
    del outs, model

    # decode_attention against its plain version: the ring caches above (bf16,
    # held per element as flash attention is), gemma3-27b's global decode
    # shape (bf16, every slot valid), the JAX package's sweep
    # (tests/test_kernels.py) in f32 at 3e-5 with one row of the first case
    # left with no valid slot (0, as the TPU kernel gives; ROADMAP C9), then
    # the bf16 tensor-core body at G = 1, 2, 3, 7, 8, 16 and head dims 64,
    # 120, 128, 256, caches ragged against its 64-key tile, one case soft-
    # capped and one row with no valid slot.
    # Bound: bytes — q, the K and V caches, the mask and the output once —
    # against 4·Dh FLOPs per (query head, slot) at the inputs' type's peak.
    # Yardstick: one SDPA call with the mask as attn_mask and GQA.
    g3 = get_config("gemma3-27b")

    def dec_inputs(b, hq_, hkv, dh_, c, fv, tdt, empty_row=False, softcap=0.0):
        q = randn(b, hq_, dh_).to(tdt)
        kc, vc = (randn(b, c, hkv, dh_).to(tdt) for _ in range(2))
        valid = torch.rand((b, c), generator=gen, device=dev) < fv
        valid[:, 0] = True
        if empty_row:
            valid[-1] = False
        return q, kc, vc, valid, softcap

    dec_cases = [("ring", lambda: (q_dec, swa[0][0], swa[0][1], ring_valid, 0.0), True),
                 ("gemma3-27b", lambda: dec_inputs(B, g3.num_heads, g3.num_kv_heads,
                                                   g3.head_dim, 32768, 1.0, torch.bfloat16),
                  False)]
    sweep = ((2, 8, 2, 64, 1024, 1.0), (1, 16, 1, 128, 2048, 0.5),
             (2, 4, 4, 80, 700, 0.8), (1, 14, 2, 64, 512, 1.0))
    dec_cases += [("sweep", lambda case=case, i=i: dec_inputs(*case, torch.float32, i == 0),
                   False) for i, case in enumerate(sweep)]
    # (b, hq, hkv, dh, c, share of valid slots, empty last row, softcap)
    dec_bf16 = ((2, 4, 4, 64, 1000, 0.8, False, 0.0), (2, 16, 8, 128, 4001, 0.9, False, 0.0),
                (1, 6, 2, 120, 777, 0.5, False, 0.0), (2, 14, 2, 64, 1500, 0.7, True, 0.0),
                (1, 16, 2, 128, 3001, 1.0, False, 0.0), (2, 16, 1, 256, 2100, 0.6, False, 50.0))
    dec_cases += [("grouped", lambda case=case: dec_inputs(*case[:6], torch.bfloat16, *case[6:]),
                   False) for case in dec_bf16]
    for label, make, main in dec_cases:
        q, kc, vc, valid, cap = make()
        b, c, hkv, dh_ = kc.shape
        hq_ = q.shape[1]
        empty = not bool(valid[-1].any())
        dt, es = ("bf16", 2) if q.dtype == torch.bfloat16 else ("f32", 4)
        nbytes = es * (2 * b * hq_ * dh_ + 2 * b * c * hkv * dh_) + b * c
        flops = {dt: 4 * dh_ * b * hq_ * c}
        library = None
        if label in ("ring", "gemma3-27b"):
            qs, ks, vs = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
            mask = valid[:, None, None, :]

            def library():
                return F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask, enable_gqa=True)[:, :, 0]
        check("decode_attention", dt, f"{label} B={b} C={c} Hq={hq_} Hkv={hkv} Dh={dh_}"
              + (f" softcap={cap}" if cap else "")
              + (" (one row with no valid slot)" if empty else ""),
              lambda: decode_attention(q, kc, vc, valid, softcap=cap),
              lambda: decode_attention_plain(q, kc, vc, valid, cap),
              nbytes, flops, main_shape=main, library=library)
        if empty and float(decode_attention(q, kc, vc, valid, softcap=cap)[-1].abs().max()) != 0.0:
            fail("decode_attention: a row with no valid slot did not give 0")
        if label == "gemma3-27b":
            # its partial and combine passes by device time, over five calls
            # (a single call's first kernel can fall outside the trace)
            device_profile(torch, "decode_attention gemma3-27b, 5 calls",
                           lambda: [decode_attention(q, kc, vc, valid) for _ in range(5)],
                           top=3)
        del q, kc, vc, valid, library
    del swa, snapshot
    torch.cuda.empty_cache()
    return launches, decode_launches


def mamba_phase(torch, K, check, dev) -> dict:
    """Phase 7; returns the serving run's launch counts."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba_scan.kernel import mamba_scan_kernel
    from repro_torch.kernels.mamba_scan.plain import mamba_scan_plain

    cfg = get_config(MAMBA_ARCH)
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # mamba_scan: the serving shape (B, S, d_inner, d_state) with inputs as
    # the block makes them (Δ = softplus of about −4.6, A = −(n+1)·e^a_log),
    # the JAX package's sweep (tests/test_kernels.py; Δ = 0.1·U, A = −2·U),
    # then the kernel's edges on the sweep's inputs: d_state 1, 3 and 5 (most
    # of its 16 register states zero-padded), d_inner 300 (a ragged last block) and
    # 301 (u and Δ copied 4 bytes at a time), S 1, 17 and 3000 (partial tiles,
    # a long run); Δ tiny (1e-3, u scaled by 10: the state is carried over
    # all 3000 steps) and Δ large (5–10 with A = −(n+1): the decay flushes
    # to 0). y and the last state are each held at 1e-4 × max(1, max
    # |plain|), the reference's tolerance. Bound: bytes — u and Δ read and y
    # written (12 per element), b, c, A and the last state — against the
    # exponentials, B·S·di·ds of them, all on the special-function units
    # (ex2.approx), 16 per clock per SM (PEAKS "exp", from the card's SM
    # count and clock); each line gives both shares. No
    # single PyTorch call computes this scan: no library time.
    scan_cases = [("serve", SERVE_BATCH, SERVE_PROMPT, cfg.mamba.d_inner, cfg.mamba.d_state),
                  ("sweep", 2, 64, 128, 8), ("sweep", 1, 300, 256, 16),
                  ("sweep", 2, 128, 300, 16), ("sweep", 2, 17, 300, 1),
                  ("sweep", 3, 1, 300, 3), ("sweep", 2, 3000, 300, 5),
                  ("sweep", 2, 17, 301, 16), ("tiny", 1, 3000, 512, 16),
                  ("large", 2, 300, 256, 16)]
    for kind, b, s, di, ds in scan_cases:
        u = randn(b, s, di)
        if kind == "serve":
            dt = F.softplus(-4.6 + randn(b, s, di))
            a = -(torch.arange(1, ds + 1, device=dev, dtype=torch.float32)[None]
                  * torch.exp(0.1 * randn(di, ds)))
        elif kind == "large":
            dt = 5.0 + 5.0 * torch.rand((b, s, di), generator=gen, device=dev)
            a = -torch.arange(1, ds + 1, device=dev, dtype=torch.float32)[None].repeat(di, 1)
        else:
            scale = 1e-3 if kind == "tiny" else 0.1
            dt = scale * torch.rand((b, s, di), generator=gen, device=dev)
            a = -2.0 * torch.rand((di, ds), generator=gen, device=dev)
            if kind == "tiny":
                u = 10.0 * u
        b_t, c_t = randn(b, s, ds), randn(b, s, ds)
        label = f"B={b} S={s} di={di} ds={ds}" + ("" if kind in ("serve", "sweep") else f" Δ {kind}")
        _, h_last = mamba_scan_kernel(u, dt, a, b_t, c_t)
        torch.cuda.synchronize()
        _, h_plain = mamba_scan_plain(u, dt, a, b_t, c_t)
        h_err = float((h_last - h_plain).abs().max())
        h_scale = max(1.0, float(h_plain.abs().max()))
        print(f"mamba_scan f32 {label}: last state max_abs_err "
              f"{h_err:.3e} (tol {TOL[('mamba_scan', 'f32')]:.0e} x {h_scale:.3g})", flush=True)
        if not h_err <= TOL[("mamba_scan", "f32")] * h_scale:
            fail(f"mamba_scan {label}: last state disagrees")
        check("mamba_scan", "f32", label,
              lambda: mamba_scan_kernel(u, dt, a, b_t, c_t)[0],
              lambda: mamba_scan_plain(u, dt, a, b_t, c_t)[0],
              4 * (3 * b * s * di + 2 * b * s * ds + di * ds + b * di * ds),
              {"exp": b * s * di * ds}, main_shape=kind == "serve")
        del u, dt, a, b_t, c_t, h_last, h_plain
    torch.cuda.empty_cache()

    launches, model, _, _ = serve_model(
        torch, K, MAMBA_ARCH, MAMBA_PARAMS,
        {"mamba_scan": cfg.layer_kinds().count("mamba")}, MAMBA_BF16_TOL, dev,
        f32_tol=F32_SERVE_TOL)
    del model
    torch.cuda.empty_cache()
    return launches


def ssd_phase(torch, K, telemetry, check, dev) -> dict:
    """Phase 12; returns the launch counts of one Mamba-2 mixer's training
    forward and backward at granite-4.0-h-small's widths."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd.kernel import ssd_bwd, ssd_fwd, ssd_pack
    from repro_torch.models import mamba2 as M2
    from repro_torch.models.common import MAMBA2_A_RANGE, MAMBA2_DT_RANGE, fill_param

    cfg = get_config(HYBRID_ARCH)
    m = cfg.mamba2
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 2)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def gap(got, want):
        d = got.double() - want.double()
        return float(d.norm() / want.double().norm().clamp_min(1e-30))

    # ssd_pack on the mixer's views of its depthwise conv's (Bt, C, S)
    # output, SiLU'd, whose channels lie a token length apart: bit for bit
    # against ``contiguous``. Bound: each element read and written once.
    s = 4096
    h, p, g, n = m.num_heads, m.head_dim, m.n_groups, m.d_state
    xbc = randn(1, h * p + 2 * g * n, s + m.d_conv - 1).bfloat16()[..., :s]
    views = torch.split(F.silu(xbc.transpose(1, 2)), [h * p, g * n, g * n], dim=-1)
    for name, view, width in zip(("x", "B", "C"), views, (p, n, n)):
        view = view.reshape(1, s, -1, width)
        check("ssd_pack", "bf16", f"{name} {tuple(view.shape)} strides {view.stride()}",
              lambda view=view: ssd_pack(view), lambda view=view: view.contiguous(),
              4 * view.numel(), {}, main_shape=name == "x", tol=0.0, measure="abs")
    del xbc, views

    # The pair at the cell's shape, a ragged two-batch length, two groups
    # and the reduced test config's shape: y and the five gradients against
    # the composition in float32 (autograd through it for the gradients) on
    # float32 upcasts of the same bf16 inputs (x, B, C SiLU'd; Δ log-uniform
    # over the init's range; A = −linspace over its range; dy normal), at
    # SSD_TOL, each also no farther from it than the bf16 composition is but
    # dA (one sum a head over every token, whose cancellation leaves either
    # side's gap at the other's order); two backward runs bit for bit.
    # Bounds, the work frozen as amt_bench's ssd_roofline freezes it, for T
    # tokens: the forward's products 2·(L/2)·(G·N + H·P) + 2·2·H·P·N a token
    # at the bf16 peak; its bytes x, B, C (bf16), Δ and y (float32) and A,
    # each once. The backward's products twice the forward's (each product's
    # gradient takes two); its bytes x, B, C, Δ and dy read, dx, dB, dC
    # (bf16) and dΔ written, A and dA.
    lo, hi = (math.log(v) for v in MAMBA2_DT_RANGE)
    cases = (("cell", 1, 4096, h, p, g, n, m.chunk_size),
             ("ragged", 2, 1000, 8, 64, 1, 128, 256),
             ("groups", 1, 777, 16, 64, 2, 64, 128),
             ("reduced", 2, 20, 4, 16, 1, 8, 8))
    for label, bsz, s, h, p, g, n, length in cases:
        x, b, c = (F.silu(randn(*shape)).bfloat16()
                   for shape in ((bsz, s, h, p), (bsz, s, g, n), (bsz, s, g, n)))
        dt = torch.exp(lo + (hi - lo) * torch.rand((bsz, s, h), generator=gen, device=dev))
        a = -torch.linspace(*MAMBA2_A_RANGE, h, device=dev)
        dy = randn(bsz, s, h, p)
        ins = (x, dt, a, b, c)
        up = [t.float() for t in ins]
        tokens = bsz * s
        fwd_flops = tokens * (2 * (length / 2) * (g * n + h * p) + 2 * 2 * h * p * n)
        fwd_bytes = tokens * (2 * h * p + 4 * h + 2 * 2 * g * n + 4 * h * p) + 4 * h
        bwd_bytes = tokens * (2 * (2 * h * p + 4 * h + 2 * 2 * g * n) + 4 * h * p) + 8 * h
        shape = f"{label} B={bsz} S={s} H={h} P={p} G={g} N={n} L={length}"
        main = label == "cell"
        check("ssd_fwd", "bf16", f"{shape} y", lambda: ssd_fwd(*ins, length)[0],
              lambda: M2.ssd(*up, length), fwd_bytes, {"bf16": fwd_flops},
              main_shape=main, tol=SSD_TOL["y"], measure="norm")
        y, *saved = ssd_fwd(*ins, length)
        want_y = M2.ssd(*up, length)
        gaps = {"y": (gap(y, want_y), gap(M2.ssd(*ins, length), want_y))}
        del y, want_y

        def plain_grads():
            leaves = [t.detach().float().requires_grad_(True) for t in ins]
            return torch.autograd.grad(M2.ssd(*leaves, length), leaves, dy)

        for i, gname in enumerate(("dx", "dΔ", "dA", "dB", "dC")):
            check("ssd_bwd", "bf16", f"{shape} {gname}",
                  lambda i=i: ssd_bwd(*ins, *saved, dy, length)[i],
                  lambda i=i: plain_grads()[i], bwd_bytes, {"bf16": 2 * fwd_flops},
                  main_shape=main, tol=SSD_TOL["grad"], measure="norm")
        first = ssd_bwd(*ins, *saved, dy, length)
        second = ssd_bwd(*ins, *saved, dy, length)
        if not all(torch.equal(u, v) for u, v in zip(first, second)):
            fail(f"ssd_bwd {shape}: two runs on the same inputs differ")
        want = plain_grads()
        comp_leaves = [t.detach().clone().requires_grad_(True) for t in ins]
        comp = torch.autograd.grad(M2.ssd(*comp_leaves, length), comp_leaves, dy)
        for i, gname in enumerate(("dx", "dΔ", "dA", "dB", "dC")):
            gaps[gname] = (gap(first[i], want[i]), gap(comp[i], want[i]))
        print(f"ssd {shape}: gaps of norms to the float32 composition, the pair's (the bf16 "
              "composition's): " + ", ".join(f"{k} {v[0]:.3e} ({v[1]:.3e})"
                                               for k, v in gaps.items())
              + "; two backward runs bit for bit", flush=True)
        farther = [k for k, (got, bf16) in gaps.items() if k != "dA" and got > bf16]
        if farther:
            fail(f"ssd {shape}: {farther} farther from float32 than the bf16 composition")
        del ins, up, saved, first, second, want, comp, comp_leaves, x, b, c, dt, a, dy
        torch.cuda.empty_cache()

    # One mixer at the cell's widths, bf16, on a 1 × 4096 microbatch,
    # launch counts from 0 and telemetry recording just before: a no-grad
    # forward (remat's first pass) runs the pair's forward once, and a
    # forward + backward the pair once (3 packs, the forward's 4 kernels
    # and the backward's 6), each scan counted as ``mamba2.ssd.kernel``;
    # then the same step timed through the pair and through the composition
    # (the route turned off), with each leaf's gradient gap between them.
    params = M2.mamba2_params(cfg)
    params.to_empty(device=dev)
    for pname, (init, scale) in params.inits.items():
        fill_param(getattr(params, pname), init, scale, SERVE_SEED, f"mixer.{pname}")
        getattr(params, pname).requires_grad_(True)
    xin = (0.5 * randn(1, 4096, cfg.d_model)).bfloat16().requires_grad_(True)
    dout = randn(1, 4096, cfg.d_model).bfloat16()
    leaves = [xin, *params.parameters()]
    names = ["x", *(pname for pname, _ in params.named_parameters())]

    def step():
        return torch.autograd.grad(M2.mamba2_fwd(xin, params, cfg), leaves, dout)

    telemetry.get().reset()
    telemetry.set_enabled(True)
    K.reset_launch_counts()
    with torch.no_grad():
        M2.mamba2_fwd(xin, params, cfg)
    fwd_launches = {k: v for k, v in K.LAUNCHES.items() if v}
    K.reset_launch_counts()
    pair = step()
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    counters = {k: v for k, v in telemetry.get().metrics()["counters"].items()
                if k.startswith("mamba2.")}
    telemetry.set_enabled(False)
    telemetry.get().reset()
    step_launches = {k: v for k, v in launches.items() if v}
    print(f"phase 12 mixer: no-grad forward launches {fwd_launches}, forward + backward "
          f"{step_launches}; counters {counters}", flush=True)
    if fwd_launches != {"ssd_pack": 3, "ssd_fwd": 1}:
        fail(f"ssd mixer: a no-grad forward launched {fwd_launches}")
    if step_launches != {"ssd_pack": 3, "ssd_fwd": 1, "ssd_bwd": 1}:
        fail(f"ssd mixer: a forward + backward launched {step_launches}")
    if counters != {"mamba2.ssd.kernel": 2}:
        fail(f"ssd mixer: the route counted {counters}, not 2 scans on the pair")
    if not all(torch.isfinite(t).all() for t in pair):
        fail("ssd mixer: a non-finite gradient through the pair")
    pair_ms = time_ms(torch, step, reps=5)
    route = M2._kernel_route
    M2._kernel_route = lambda x: False  # the composition
    try:
        comp = step()
        comp_ms = time_ms(torch, step, reps=5)
    finally:
        M2._kernel_route = route
    print(f"phase 12 mixer {HYBRID_ARCH} (d_model {cfg.d_model}, {m.num_heads} heads of "
          f"{m.head_dim}, state {m.d_state}, chunks of {m.chunk_size}), 1 x 4096 tokens, bf16: "
          f"forward + backward "
          f"{pair_ms:.3f} ms through the pair, {comp_ms:.3f} ms through the composition; "
          "gradient gaps of norms pair to composition: " + ", ".join(
              f"{nm} {gap(u, v):.3e}" for nm, u, v in zip(names, pair, comp)), flush=True)
    del params, xin, dout, leaves, pair, comp
    torch.cuda.empty_cache()
    return launches


def train_phase(np, torch, K, telemetry, card, checked_buckets, dev) -> dict:
    """Phase 10, the paper's use case: AMT tunes real training of
    granite-moe-1b-a400m at its full published widths and depth. (m) serve
    it with the kernels (counted) and hold it against the torch composition;
    train ten steps; restart from a checkpoint bit for bit at two layers.
    (n) an 8-trial BO tuning job of full-width training trials under the
    median rule. Returns ({"serve": (m)'s serving counts, "tune": (n)'s},
    {"prefill_ms", "step_ms": (m)'s serving times, "train_step_ms": the
    train step median, "train_peak": its peak memory})."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core import (BOConfig, BOSuggester, MedianRule, Tuner,
                                  TuningJobConfig)
    from repro_torch.core.history import bucket_size
    from repro_torch.core.scheduler import ThreadBackend
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.train import build_objective, default_search_space
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, make_train_step
    from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.training.train_step import init_train_state, train_state_of

    cfg = get_config(GRANITE_ARCH)
    print(f"phase 10 on {card}: {GRANITE_ARCH}, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} of {cfg.moe.d_expert}, "
          f"vocab {cfg.vocab_size}", flush=True)

    # (m) serve: 24 flash_attention launches a prefill; the torch
    # composition takes the kernel run's expert choices (MoERouting)
    t0 = time.perf_counter()
    routing = MoERouting(torch)
    try:
        serve_launches, model, _, serve_times = serve_model(
            torch, K, GRANITE_ARCH, GRANITE_PARAMS,
            {"flash_attention": cfg.layer_kinds().count("attn")}, GRANITE_BF16_TOL,
            dev, f32_tol=F32_SERVE_TOL, routing=routing)
    finally:
        routing.close()
    del model
    torch.cuda.empty_cache()
    print(f"phase 10 (m) serve on {card}: passed in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # (m) train: ten steps at the published widths and depth (microbatches
    # 2, remat on), AdamW lr 1e-3, warmup 2, total 10
    t0 = time.perf_counter()
    opt = AdamWConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    ds = SyntheticLMDataset(cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=0)
    model = build_model(cfg, impl="torch")
    state = init_train_state(model, SERVE_SEED, opt)
    step = make_train_step(model, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, norms, step_ms = [], [], []
    for i in range(TRAIN_STEPS):
        batch = ds.batch(i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        print(f"  train step {i + 1}: loss {losses[-1]:.6f} (ce {float(metrics['ce']):.6f}, "
              f"aux {float(metrics['aux']):.6f}), grad_norm {norms[-1]:.6f}, lr "
              f"{float(metrics['lr']):.3e}, {step_ms[-1]:.3f} ms", flush=True)
    peak = torch.cuda.max_memory_allocated()
    # two eager steps and the captured one launch; replays count nothing
    step_launches = dict(K.LAUNCHES)
    if not all(step_launches[n] > 0 for n in (
            "flash_attention", "flash_attention_bwd_dot", "flash_attention_bwd_dkdv",
            "flash_attention_bwd_dq")):
        fail(f"train: the step did not run the flash-attention pair: {step_launches}")
    med = statistics.median(step_ms[2:])
    numbers = {"prefill_ms": serve_times["prefill_ms"], "step_ms": serve_times["step_ms"],
               "train_step_ms": med, "train_peak": peak}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"phase 10 (m) train on {card}: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens ({cfg.microbatches} microbatches, remat {cfg.remat}); step median over "
          f"steps 3-{TRAIN_STEPS} {med:.3f} ms (min {min(step_ms[2:]):.3f}, max "
          f"{max(step_ms[2:]):.3f}), {tokens * 1e3 / med:.1f} tokens/s; peak memory "
          f"{peak / 1e9:.2f} GB; loss {losses[0]:.6f} -> {losses[-1]:.6f}", flush=True)
    if not all(math.isfinite(v) for v in losses + norms) or min(norms) <= 0:
        fail("train: a loss or grad_norm not finite, or a zero gradient")
    if not losses[-1] < losses[0]:
        fail(f"train: the last loss {losses[-1]} is not below the first {losses[0]}")
    device_profile(torch, "train step", lambda: step(state, ds.batch(TRAIN_STEPS)), top=20)
    del model, state, step
    torch.cuda.empty_cache()
    print(f"phase 10 (m) train: {time.perf_counter() - t0:.1f} s", flush=True)

    # (m) restart, at full width and 2 layers under deterministic
    # algorithms: 6 steps straight against 3 steps, a checkpoint, a fresh
    # model loaded from it and 3 more steps; parameters, moments and step
    # bit for bit
    t0 = time.perf_counter()
    small = dataclasses.replace(cfg, num_layers=2)
    torch.use_deterministic_algorithms(True)
    try:
        straight = build_model(small, impl="torch")
        s_state = init_train_state(straight, SERVE_SEED, opt)
        s_step = make_train_step(straight, opt)
        for i in range(6):
            s_state, _ = s_step(s_state, ds.batch(i))
        first = build_model(small, impl="torch")
        f_state = init_train_state(first, SERVE_SEED, opt)
        f_step = make_train_step(first, opt)
        for i in range(3):
            f_state, _ = f_step(f_state, ds.batch(i))
        with tempfile.TemporaryDirectory() as tmp:
            path = save_checkpoint(tmp, 3, f_state, cfg=small)
            size = os.path.getsize(path)
            del first, f_state, f_step
            resumed = build_model(small, impl="torch")
            r_state, _ = load_checkpoint(tmp, 3, train_state_of(resumed.init(SERVE_SEED + 1), opt),
                                         cfg=small)
        r_step = make_train_step(resumed, opt)
        for i in range(3, 6):
            r_state, _ = r_step(r_state, ds.batch(i))
        torch.cuda.synchronize()
        bad = [name for name in s_state.params
               if not (torch.equal(s_state.params[name], r_state.params[name])
                       and torch.equal(s_state.opt["m"][name], r_state.opt["m"][name])
                       and torch.equal(s_state.opt["v"][name], r_state.opt["v"][name]))]
        steps_equal = int(s_state.opt["step"]) == int(r_state.opt["step"]) == 6
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"phase 10 (m) restart on {card}: 2 layers, {straight.num_params()} parameters, "
          f"checkpoint {size / 1e9:.3f} GB; 6 steps straight vs 3 + checkpoint + 3: "
          f"{len(s_state.params) - len(bad)} of {len(s_state.params)} parameters with m and v "
          f"bit for bit, step {int(r_state.opt['step'])}, in {time.perf_counter() - t0:.1f} s",
          flush=True)
    if bad or not steps_equal:
        fail(f"restart: not bit for bit ({bad[:4]}, steps equal {steps_equal})")
    del straight, s_state, s_step, resumed, r_state, r_step
    torch.cuda.empty_cache()

    # (n) the tuning job: 8 full-width training trials, 2 in flight, the
    # median rule, BO decisions on the kernels (fit_backend "kernel" puts
    # slice_chain on the path)
    t0 = time.perf_counter()
    # the trials' common start: the eval loss of the seeded, untrained model
    # on the launcher's held-out batch
    start = build_model(cfg, impl="torch").init(0)
    eval_batch = SyntheticLMDataset(cfg.vocab_size, seq_len=64, global_batch=8,
                                    seed=0).batch(10_000)
    with torch.no_grad():
        start_loss, start_parts = start.loss_fn(eval_batch)
        start_loss, start_ce = float(start_loss), float(start_parts["ce"])
    del start
    torch.cuda.empty_cache()
    space = default_search_space()
    objective = build_objective(GRANITE_ARCH, steps=TUNE_STEPS, eval_every=TUNE_EVERY,
                                full_config=True)
    backend = ThreadBackend(max_workers=2)
    tuner = Tuner(space, objective,
                  BOSuggester(space, BOConfig(num_init=3, fit_backend="kernel").fast(), seed=0),
                  backend, TuningJobConfig(max_trials=TUNE_TRIALS, max_parallel=2),
                  stopping_rule=MedianRule())
    telemetry.get().reset()
    telemetry.set_enabled(True)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    try:
        res = tuner.run()
    finally:
        backend.shutdown()
    torch.cuda.synchronize()
    tune_launches = dict(K.LAUNCHES)
    telemetry.set_enabled(False)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    by_id = {}
    for ev in telemetry.get().trace_events():
        if ev.get("kind") == "span":
            by_id[ev["span_id"]] = ev

    def decision_of(ev):
        up = by_id.get(ev["parent_id"])
        while up is not None and up["name"] != "suggest.decide":
            up = by_id.get(up["parent_id"])
        return None if up is None else up["span_id"]

    posts = [ev for ev in by_id.values() if ev["name"] == "suggest.posterior"]
    gp_ids = {decision_of(ev) for ev in posts} - {None}
    dec = sorted(by_id[i]["dur"] * 1e3 for i in gp_ids)
    print(f"phase 10 (n) tuning job on {card}: {len(res.trials)} trials in {wall:.1f} s, "
          f"{res.num_early_stopped} stopped early, {res.num_failed_attempts} failed "
          f"attempts, best eval loss {res.best_objective:.6f} against the untrained "
          f"model's {start_loss:.6f} (cross-entropy {start_ce:.6f}; ln V = "
          f"{math.log(cfg.vocab_size):.6f}); peak memory {peak / 1e9:.2f} GB", flush=True)
    for t in res.trials:
        hp = ", ".join(f"{k} {v:.4g}" for k, v in t.config.items())
        took = (t.end_time - t.start_time) if t.end_time is not None and t.start_time is not None else math.nan
        print(f"  trial {t.trial_id}: {t.state}, {len(t.curve)} evals, curve "
              f"{[round(v, 4) for v in t.curve]}, {took:.1f} s; {hp}", flush=True)
        if t.error:
            print("    " + t.error.strip().replace("\n", "\n    "), flush=True)
    if len(dec) and len(dec) == len(gp_ids):
        print(f"  GP decisions {len(dec)}: p50 {statistics.median(dec):.2f} ms, max "
              f"{dec[-1]:.2f} ms; launches {tune_launches}", flush=True)
    if len(res.trials) != TUNE_TRIALS or res.num_failed_attempts:
        fail(f"tuning job: {len(res.trials)} trials, {res.num_failed_attempts} failed attempts")
    if any(t.state not in ("COMPLETED", "STOPPED") for t in res.trials):
        fail("tuning job: a trial neither completed nor stopped")
    if not all(math.isfinite(v) for t in res.trials for v in t.curve):
        fail("tuning job: a reported eval loss is not finite")
    if not res.best_objective < start_loss:
        fail(f"tuning job: best eval loss {res.best_objective} not below the untrained "
             f"model's {start_loss}")
    if not dec:
        fail("tuning job: no GP decision")
    if tune_launches["acq_score"] != 2 * len(dec) or tune_launches["slice_chain"] > len(dec) \
            or tune_launches["slice_chain"] == 0 or tune_launches["matern52_operand"] == 0:
        fail(f"tuning job: launches {tune_launches} for {len(dec)} GP decisions")
    ns = [ev["attrs"]["n"] for ev in posts]
    buckets = {bucket_size(n) for n in ns}
    if not buckets <= checked_buckets["acq_score"]:
        fail(f"tuning job: acq_score at buckets {sorted(buckets)} not all held in phase 2")
    print(f"phase 10 (n): {len(dec)} GP decisions, acq_score {tune_launches['acq_score']} "
          f"({tune_launches['acq_score'] / len(dec):.1f} a decision), slice_chain "
          f"{tune_launches['slice_chain']} ({tune_launches['slice_chain'] / len(dec):.2f}), "
          f"matern52_operand {tune_launches['matern52_operand']}; rows {min(ns)}..{max(ns)}, "
          f"buckets {sorted(buckets)}; {wall:.1f} s", flush=True)
    return {"serve": serve_launches, "train": step_launches, "tune": tune_launches}, numbers


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def start_dryruns(out_dir: str) -> dict:
    """(p) and (q) as subprocesses of the port's dry-run (a process has one
    default group; this one's is the card's NCCL group): qwen3-moe-235b-a22b
    × ``DRYRUN_SHAPES`` on the 16×16 production mesh through the CLI, and
    granite's phase-10 training step on a (1, 1) mesh through
    ``lower_cell``. Started together; ``finish_dryruns`` collects them."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(HERE, "src"), env.get("PYTHONPATH", "")) if p)
    procs = {}
    for shape in DRYRUN_SHAPES:
        log = open(os.path.join(out_dir, f"{shape}.log"), "w")
        procs[shape] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", DRYRUN_ARCH,
             "--shape", shape, "--out", out_dir],
            stdout=log, stderr=subprocess.STDOUT, text=True, env=env, cwd=HERE), log)
    script = (
        "import json\n"
        "from repro_torch.configs.base import ShapeConfig\n"
        "from repro_torch.launch.dryrun import lower_cell\n"
        f"r = lower_cell({GRANITE_ARCH!r}, 'train_1k', mesh_shape=(1, 1),\n"
        f"               shape=ShapeConfig('train_1k', {TRAIN_SEQ}, {TRAIN_BATCH}, 'train'))\n"
        f"json.dump(r, open({os.path.join(out_dir, 'granite_train.json')!r}, 'w'))\n")
    log = open(os.path.join(out_dir, "granite.log"), "w")
    procs["granite"] = (subprocess.Popen([sys.executable, "-c", script], stdout=log,
                                         stderr=subprocess.STDOUT, text=True, env=env,
                                         cwd=HERE), log)
    return procs


def stop_dryruns(procs: dict) -> None:
    """Kill the dry-run subprocesses still running and close their logs."""
    for proc, log in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        log.close()


def finish_dryruns(procs: dict, out_dir: str) -> dict:
    """Wait for the dry-run subprocesses (all are killed if any is still
    running after ``DRYRUN_TIMEOUT`` s from now) and read their records."""
    deadline = time.perf_counter() + DRYRUN_TIMEOUT
    try:
        for key, (proc, _) in procs.items():
            try:
                proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                fail(f"(p) dry-run {key} still running after {DRYRUN_TIMEOUT} s")
    finally:
        stop_dryruns(procs)
    records = {}
    for key, (proc, log) in procs.items():
        if proc.returncode != 0:
            with open(log.name) as f:
                tail = f.read()[-3000:]
            fail(f"(p) dry-run {key} exited with {proc.returncode}:\n{tail}")
        path = (os.path.join(out_dir, "granite_train.json") if key == "granite" else
                os.path.join(out_dir, f"{DRYRUN_ARCH}__{key}__pod1.json"))
        with open(path) as f:
            records[key] = json.load(f)
    return records


def mesh_phase(torch, K, card, dev, phase10) -> dict:
    """Phase 11, sharding on the card. (o) granite-moe-1b-a400m at full
    width and depth through ``make_local_mesh()`` = (1, 1) over a real
    one-rank NCCL group, seeded as phase 10 seeds it, with ``DEFAULT_RULES``
    (``ShardCtx`` constraints and ``local_map`` kernel calls live): phase
    10's four 3000-token requests served for 16 greedy tokens with the
    kernels (24 ``flash_attention`` launches, one prefill) and trained for
    ``MESH_TRAIN_STEPS`` steps of 16 × 1024 tokens; both held bit for bit
    against the same run with no mesh — tokens, prefill logits and KV
    caches, each step's loss, ce, aux and grad_norm, every parameter after
    the steps. (p) the production-mesh dry-run of qwen3-moe-235b-a22b
    (``train_4k`` and ``decode_32k`` on 16×16) as subprocesses on the
    card's host: status OK, per-device parameter bytes equal to the sharding
    rules' shape arithmetic, the decode cell on its ``cache_seq="model"``
    override. (q) the dry-run's estimate of (o)'s training step, traced on a
    (1, 1) mesh, against the card: the estimated per-device peak within
    ``ESTIMATE_TOL`` of ``max_memory_allocated``; the traced FLOPs beside
    ``model_flops``. Returns (o)'s serving launch counts."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.distributed.sharding import shard_shape
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.roofline import H100_SXM, model_flops
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, greedy_generate, make_prefill, make_train_step
    from repro_torch.training.train_step import init_train_state

    cfg = get_config(GRANITE_ARCH)
    B, S, NEW = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    opt = AdamWConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    ds = SyntheticLMDataset(cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=0)
    n_steps = MESH_TRAIN_STEPS + MESH_TIMED_STEPS

    def whole(t):
        """A DTensor's whole value (on a one-rank mesh, its local tensor)."""
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def serve(mesh):
        """(tokens, prefill logits, caches, launches, prefill ms) of the
        kernel run, on ``mesh`` or none."""
        model = build_model(cfg, impl="kernel", mesh=mesh).init(SERVE_SEED)
        gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
        prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
        K.reset_launch_counts()
        tokens = greedy_generate(model, prompt, NEW, S + NEW)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        prefill = make_prefill(model, S + NEW)
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = prefill(prompt)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        caches = [tuple(whole(t) for t in c) for c in caches]
        del model
        return tokens, whole(logits), caches, launches, statistics.median(ms)

    def train(mesh):
        """(per-step metrics, parameters after MESH_TRAIN_STEPS steps on the
        host, median ms of the steps after them, peak memory)."""
        model = build_model(cfg, impl="torch", mesh=mesh)
        state = init_train_state(model, SERVE_SEED, opt)
        step = make_train_step(model, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics, ms, params = [], [], None
        for i in range(n_steps):
            batch = ds.batch(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if i < MESH_TRAIN_STEPS:
                metrics.append({k: whole(v).cpu() for k, v in m.items()})
            if i + 1 == MESH_TRAIN_STEPS:
                params = {k: whole(p).detach().cpu() for k, p in state.params.items()}
        peak = torch.cuda.max_memory_allocated()
        del model, state, step
        torch.cuda.empty_cache()
        return metrics, params, statistics.median(ms[MESH_TRAIN_STEPS:]), peak

    tmp = tempfile.mkdtemp(prefix="dryrun_")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_local_mesh("cuda")
        print(f"phase 11 on {card}: {GRANITE_ARCH} on mesh {tuple(mesh.shape)} "
              f"{mesh.mesh_dim_names} over a one-rank {dist.get_backend()} group", flush=True)

        # (o) serve: no mesh, then the mesh; bit for bit
        t0 = time.perf_counter()
        ref = serve(None)
        torch.cuda.empty_cache()
        got = serve(mesh)
        torch.cuda.empty_cache()
        launches = got[3]
        n_attn = cfg.layer_kinds().count("attn")
        tok_eq = torch.equal(ref[0], got[0])
        logit_d = float((ref[1] - got[1]).abs().max())
        cache_d = max(float((a - b).abs().max()) for ra, rb in zip(ref[2], got[2])
                      for a, b in zip(ra, rb))
        print(f"phase 11 (o) serve on {card}: mesh launches {launches}; tokens "
              f"{'equal' if tok_eq else 'DIFFER'}, prefill logits max |Δ| {logit_d:.3e}, KV "
              f"caches max |Δ| {cache_d:.3e} against the run with no mesh; prefill "
              f"{got[4]:.3f} ms on the mesh, {ref[4]:.3f} ms without (phase 10's "
              f"{phase10['prefill_ms']:.3f} ms); {time.perf_counter() - t0:.1f} s", flush=True)
        for kname in K.KERNEL_NAMES:
            want = n_attn if kname == "flash_attention" else 0
            if launches[kname] != want:
                fail(f"(o) serve on the mesh: {launches[kname]} {kname} launches, not {want}")
        if not tok_eq or logit_d != 0.0 or cache_d != 0.0:
            fail("(o) serve: the mesh run is not bit for bit the run with no mesh")
        del ref, got

        # (p) and (q) trace on the host meanwhile: the timed steps replay
        # one CUDA graph and wait on the card, not on the host
        t_dry = time.perf_counter()
        procs = start_dryruns(tmp)
        try:
            # (o) train: no mesh, then the mesh; bit for bit
            t0 = time.perf_counter()
            r_met, r_par, r_ms, r_peak = train(None)
            m_met, m_par, m_ms, m_peak = train(mesh)
        except BaseException:
            stop_dryruns(procs)
            raise
        for i, (a, b) in enumerate(zip(r_met, m_met)):
            print(f"  step {i + 1}: loss {float(b['loss']):.6f} grad_norm "
                  f"{float(b['grad_norm']):.6f} on the mesh; "
                  + ", ".join(f"{k} {'equal' if torch.equal(a[k], b[k]) else 'DIFFERS'}"
                              for k in sorted(a)), flush=True)
        bad_m = [(i, k) for i, (a, b) in enumerate(zip(r_met, m_met)) for k in a
                 if not torch.equal(a[k], b[k])]
        bad_p = [k for k in r_par if not torch.equal(r_par[k], m_par[k])]
        print(f"phase 11 (o) train on {card}: {MESH_TRAIN_STEPS} steps of {TRAIN_BATCH} x "
              f"{TRAIN_SEQ} tokens ({cfg.microbatches} microbatches, remat), then "
              f"{MESH_TIMED_STEPS} timed; {len(r_par) - len(bad_p)} of {len(r_par)} parameters "
              f"bit for bit; step median {m_ms:.3f} ms on the mesh, {r_ms:.3f} ms without "
              f"(phase 10's {phase10['train_step_ms']:.3f} ms); peak memory "
              f"{m_peak / 1e9:.2f} GB on the mesh, {r_peak / 1e9:.2f} GB without (phase 10's "
              f"{phase10['train_peak'] / 1e9:.2f} GB); {time.perf_counter() - t0:.1f} s",
              flush=True)
        if bad_m or bad_p:
            stop_dryruns(procs)
            fail(f"(o) train: the mesh run is not bit for bit ({bad_m[:4]}, {bad_p[:4]})")
        del r_par, m_par
    finally:
        dist.destroy_process_group()

    # (p) + (q): the dry-runs, traced on the host since (o)'s training began
    records = finish_dryruns(procs, tmp)
    print(f"phase 11 (p)/(q) dry-runs on {card}'s host: {time.perf_counter() - t_dry:.1f} s "
          f"from their start", flush=True)
    qwen = get_config(DRYRUN_ARCH)
    prod = {"data": 16, "model": 16}
    specs = build_model(qwen, impl="torch", device="cpu", mesh=prod).param_specs()
    shapes = build_model(qwen, impl="torch", device="cpu").abstract_params()
    want_bytes = sum(math.prod(shard_shape(shapes[n].shape, s, prod)) * shapes[n].element_size()
                     for n, s in specs.items())
    for shape in DRYRUN_SHAPES:
        r = records[shape]
        t = r.get("roofline", {})
        print(f"phase 11 (p) {DRYRUN_ARCH} × {shape} on {r['mesh']} ({r.get('card')}): "
              f"status {r['status']}, rules {r.get('rules')}, microbatches "
              f"{r.get('microbatches')}, trace {r.get('trace_s')} s; per device: params "
              f"{r.get('param_bytes')} B (shape arithmetic {want_bytes}), FLOPs "
              f"{r.get('flops'):.6e}, bytes {r.get('bytes'):.6e}, collective bytes "
              f"{r.get('collective_bytes')}; roofline on {r.get('target')}: compute "
              f"{t.get('compute_s'):.6f} s, memory {t.get('memory_s'):.6f} s, collective "
              f"{t.get('collective_s'):.6f} s → {t.get('bottleneck')}-bound, useful "
              f"{t.get('useful_ratio'):.4f}; device_bytes_estimate "
              f"{r.get('device_bytes_estimate')} of {r.get('hbm_capacity')}, fits_hbm "
              f"{r.get('fits_hbm')}", flush=True)
        if r["status"] != "OK":
            fail(f"(p) {DRYRUN_ARCH} × {shape}: status {r['status']}")
        for field in ("op_flops", "op_bytes"):
            top = list(r[field].items())[:4]
            print(f"  {shape} {field} (per device, top 4): "
                  + ", ".join(f"{k} {v:.4e}" for k, v in top), flush=True)
        if r["param_bytes"] != want_bytes:
            fail(f"(p) {shape}: {r['param_bytes']} parameter bytes a device, the rules' "
                 f"shape arithmetic gives {want_bytes}")
    if records["decode_32k"]["rules"] != {"cache_seq": "model"}:
        fail(f"(p) decode_32k: rules {records['decode_32k']['rules']}, not the cache_seq override")

    # (q) the estimate against (o)'s measurement on the mesh
    r = records["granite"]
    est, flops = r["device_bytes_estimate"], r["flops"]
    mf = model_flops(cfg, ShapeConfig("train_1k", TRAIN_SEQ, TRAIN_BATCH, "train"))
    share = mf / (m_ms / 1e3) / H100_SXM.peak_flops
    gap = est / m_peak - 1.0
    print(f"phase 11 (q) on {card}: the dry-run's estimate of (o)'s step on a (1, 1) mesh "
          f"(trace {r['trace_s']} s): peak {est / 1e9:.3f} GB against "
          f"max_memory_allocated {m_peak / 1e9:.3f} GB ({gap:+.1%}, tol "
          f"±{ESTIMATE_TOL:.0%}); traced FLOPs {flops:.6e} against model_flops {mf:.6e} "
          f"(useful share {mf / flops:.4f}); traced bytes {r['bytes']:.6e}; the measured "
          f"step {m_ms:.3f} ms is {share:.2%} of the bf16 peak {H100_SXM.peak_flops:.3e} "
          f"FLOP/s (data sheet); roofline bound {r['roofline']['bottleneck']}", flush=True)
    if r["status"] != "OK" or abs(gap) > ESTIMATE_TOL:
        fail(f"(q) the estimated peak {est} is not within {ESTIMATE_TOL:.0%} of {m_peak}")
    return launches


def section5_phase(np, torch, K, telemetry, space, objective, paper, drive, run_job,
                   card) -> dict:
    """Phase 8, the paper's §5 features on the card at the paper's engine
    configuration: (e) early stopping (median rule, ASHA), (f) two jobs on
    one ``SelectionService`` (GPHP pool adoption; a factor arena small
    enough to evict; the same jobs without the pool), (g) in-service
    multi-fidelity (``acq_score_multi``'s rungs mode on every rung-aware
    decision) and (h) the reference's BO-beats-random quality gate.
    Returns each path's launch counts, by kernel."""
    from repro_torch.core import (
        ASHAConfig, ASHARule, BOConfig, BOSuggester, MedianRule, SelectionService,
        ServiceConfig, Tuner, TuningJobConfig,
    )
    from repro_torch.core.blackbox import TabulatedBackend, quadratic_table
    from repro_torch.core.gp.slice_sampler import SliceSamplerConfig

    print(f"phase 8 on {card}", flush=True)
    out = {}

    def table_of(res):
        return np.stack([space.encode(t.config) for t in res.trials])

    def same_under_torch_scoring(label, res, tuner_kw_of, **job):
        """The job again with the torch composition scoring the anchors: the
        trial table must be the fused kernels' (max |Δ| ≤ 1e-9, as phase 3)."""
        cfg = BOConfig(**{**paper, "backend": "torch"})
        _, ref = run_job(cfg, 24, 4, objective, tuner_kw_of(), **job)
        got, want = table_of(res), table_of(ref)
        diff = float(np.abs(got - want).max()) if got.shape == want.shape else math.inf
        print(f"  {label}: kernel vs torch scoring max |Δ| {diff:.3e} (tol 1e-9), "
              f"states equal {[t.state for t in res.trials] == [t.state for t in ref.trials]}",
              flush=True)
        if diff > 1e-9 or [t.state for t in res.trials] != [t.state for t in ref.trials]:
            fail(f"{label}: the trial table moves with the scoring backend")

    # (e) early stopping: the objective reports its 10-point learning curve
    for key, make_rule in (("e_median", MedianRule), ("e_asha", ASHARule)):
        label = f"(e) {key[2:]} rule"
        _, res, launches = drive(label, BOConfig(**paper), 24, 4, "acq_score",
                                 tuner_kw={"stopping_rule": make_rule()}, stopped_ok=True)
        stopped = [t.trial_id for t in res.trials if t.state == "STOPPED"]
        print(f"  {label}: {len(stopped)} trials stopped early {stopped}, "
              f"{sum(len(t.curve) for t in res.trials)} of "
              f"{10 * len(res.trials)} iterations run; {card}", flush=True)
        if not stopped or res.num_early_stopped != len(stopped):
            fail(f"{label}: no trial stopped early")
        same_under_torch_scoring(label, res, lambda: {"stopping_rule": make_rule()})
        out[key] = launches

    # (f) two jobs on one service: decisions interleaved, each job keeping 4
    # trials in flight (the oldest completes, one new trial is suggested)
    def service_pair(label, share, budget_mb, refit_every=1):
        cfg = BOConfig(**{**paper, "refit_every": refit_every})
        svc = SelectionService(ServiceConfig(
            share_gphp=share, sibling_warm_start=False, arena_budget_mb=budget_mb,
            default_bo_config=cfg))
        handles = [svc.register_job(f"job-{j}", space, seed=j) for j in (0, 1)]
        telemetry.get().reset()
        telemetry.set_enabled(True)
        K.reset_launch_counts()
        inflight = [[], []]
        tables = [[], []]
        decide_ms = [[], []]
        while any(len(tables[j]) < 24 or inflight[j] for j in (0, 1)):
            for j, h in enumerate(handles):
                if inflight[j] and (len(inflight[j]) == 4 or len(tables[j]) == 24):
                    tid, c = inflight[j].pop(0)
                    h.store.clear_pending(tid)
                    h.store.push(c, float(objective(c)[0][-1]), key=tid)
                free = min(4 - len(inflight[j]), 24 - len(tables[j]))
                if free <= 0:
                    continue
                gp = h.store.num_observations >= max(2, cfg.num_init)
                t0 = time.perf_counter()
                batch = h.suggest_batch(free)
                torch.cuda.synchronize()
                if gp:
                    decide_ms[j].append((time.perf_counter() - t0) * 1e3)
                for c in batch:
                    tid = len(tables[j])
                    h.store.mark_pending(tid, c)
                    inflight[j].append((tid, c))
                    tables[j].append(space.encode(c))
        launches = dict(K.LAUNCHES)
        counters = telemetry.get().metrics()["counters"]
        spans = {}
        for ev in telemetry.get().trace_events():
            if ev.get("kind") == "span":
                spans[ev["name"]] = spans.get(ev["name"], 0) + 1
        telemetry.set_enabled(False)
        decisions = spans.get("suggest.posterior", 0)
        adopt = counters.get("suggest.gphp.adopt", 0)
        refit = counters.get("suggest.gphp.refit", 0)
        rebuilt = spans.get("suggest.factor_rebuild", 0)
        print(f"{label}: 2 x 24 trials, {decisions} GP decisions, {adopt} adoptions, "
              f"{refit} refits, slice_chain {launches['slice_chain']} launches "
              f"({launches['slice_chain'] / max(decisions, 1):.3f} per GP decision), "
              f"{rebuilt} replayed rebuilds, arena evictions {svc.arena.evictions}, "
              f"pool {svc.stats()['groups'][0]['pool']}; decision p50 "
              + ", ".join(f"job-{j} {statistics.median(decide_ms[j]):.2f} ms "
                          f"(n={len(decide_ms[j])})" for j in (0, 1))
              + f"; {card}", flush=True)
        for k in ("acq_score", "slice_chain", "matern52_operand", "matern52_cross"):
            if launches[k] == 0:
                fail(f"{label} never launched {k}")
        if launches["slice_chain"] != refit or spans.get("suggest.gphp_fit", 0) != refit:
            fail(f"{label}: {launches['slice_chain']} slice_chain launches for {refit} refits")
        if launches["matern52_operand"] != spans.get("suggest.factorize", 0) + rebuilt:
            fail(f"{label}: {launches['matern52_operand']} matern52_operand launches for "
                 f"{spans.get('suggest.factorize', 0)} factorizations and {rebuilt} rebuilds")
        # a refit after every observation: each GP decision refits or adopts
        if refit_every == 1 and adopt + refit != decisions:
            fail(f"{label}: {adopt} adoptions + {refit} refits for {decisions} GP decisions")
        return [np.stack(t) for t in tables], launches, adopt, decisions, svc.arena.evictions

    def under_eviction(label, roomy_tables, refit_every):
        """The same two jobs under an arena too small for any factor but the
        deciding job's (each decision evicts the other job's): evictions, and
        both trial tables bit for bit."""
        tables, _, _, _, evictions = service_pair(
            f"{label}, 1e-6 MB arena", True, 1e-6, refit_every)
        if evictions == 0:
            fail(f"{label}: the small arena never evicted")
        for j in (0, 1):
            if not np.array_equal(tables[j], roomy_tables[j]):
                fail(f"{label}: job-{j}'s trial table moved under eviction")
        print(f"  {label}: both trial tables bit for bit under {evictions} evictions",
              flush=True)

    label = "(f) service, shared GPHP pool"
    pool_tables, launches, adopt, decisions, _ = service_pair(label, True, 256.0)
    if adopt == 0 or launches["slice_chain"] >= decisions:
        fail("(f) service: no adoption, or as many slice_chain launches as GP decisions")
    out["f"] = launches
    under_eviction(label, pool_tables, 1)
    service_pair("(f) service, no pool (share_gphp=False)", False, 256.0)
    # with a refit every 3 observations an evicted factor is rebuilt by
    # replaying the boundary factorization and the appends since it
    label = "(f) service, shared pool, refit every 3"
    pool_tables, _, _, _, _ = service_pair(label, True, 256.0, 3)
    under_eviction(label, pool_tables, 3)

    # (g) multi-fidelity: in-service ASHA, rung-aware decisions score through
    # acq_score_multi's rungs mode (2 launches a slot: anchors, re-rank)
    mf = ASHAConfig(r_min=1, eta=3, max_rungs=3)

    def mf_kw():
        return {"service": SelectionService(ServiceConfig(sibling_warm_start=False))}

    _, res, launches = drive("(g) multi-fidelity", BOConfig(**paper), 24, 4, "acq_score_multi",
                             tuner_kw=mf_kw(), stopped_ok=True, multi_fidelity=mf,
                             job_name="mf")
    rung_slots = [ev["attrs"]["k"] for ev in telemetry.get().trace_events()
                  if ev.get("kind") == "span" and ev["name"] == "suggest.rungs"]
    stopped = [t.trial_id for t in res.trials if t.state == "STOPPED"]
    print(f"  (g): {len(rung_slots)} rung-aware decisions ({sum(rung_slots)} slots), "
          f"acq_score_multi {launches['acq_score_multi']} launches (expected "
          f"{2 * sum(rung_slots)}), {len(stopped)} trials stopped at a rung {stopped}; "
          f"{card}", flush=True)
    if not rung_slots or launches["acq_score_multi"] != 2 * sum(rung_slots):
        fail("(g) multi-fidelity: acq_score_multi did not launch on every rung-aware "
             "decision")
    if not stopped:
        fail("(g) multi-fidelity: no trial stopped at a rung")
    same_under_torch_scoring("(g) multi-fidelity", res, mf_kw, multi_fidelity=mf,
                             job_name="mf")
    out["g"] = launches

    # (h) the reference's quality gate (tests/test_quality_gate.py) with the
    # kernels on: BO's mean best over seeds 0-2 below random's and below 0.05
    table = quadratic_table()
    gate = BOConfig(num_init=6, slice_config=SliceSamplerConfig(
        num_samples=12, burn_in=6, thin=2), refit_every=3, cost_cooling=2.0,
        backend="kernel", fit_backend="kernel")

    class Random:
        def __init__(self, seed):
            self.rng = np.random.default_rng(seed)

        def suggest_batch(self, k):
            return table.space.sample(self.rng, k)

    def gate_run(sugg, seed):
        backend = TabulatedBackend(table, startup_cost=0.05)
        res = Tuner(table.space, table.objective, sugg, backend, TuningJobConfig(
            max_trials=20, max_parallel=2, seed=seed, job_name=f"gate-{seed}")).run()
        if backend.evaluations != 20:
            fail("(h) quality gate: not 20 evaluations")
        return float(res.best_trial.objective)

    K.reset_launch_counts()
    bo = [gate_run(BOSuggester(table.space, gate, seed=s), s) for s in (0, 1, 2)]
    gate_launches = dict(K.LAUNCHES)
    rand = [gate_run(Random(s), s) for s in (0, 1, 2)]
    print(f"(h) quality gate: BO best {bo} (mean {np.mean(bo):.6f}), random {rand} "
          f"(mean {np.mean(rand):.6f}); acq_score {gate_launches['acq_score']}, "
          f"slice_chain {gate_launches['slice_chain']} launches; {card}", flush=True)
    if not np.mean(bo) < np.mean(rand) or not np.mean(bo) < 0.05:
        fail("(h) quality gate: BO does not beat random on the quadratic table")
    if gate_launches["acq_score"] == 0 or gate_launches["slice_chain"] == 0:
        fail("(h) quality gate: the kernels did not run")
    out["h"] = gate_launches
    return out



def large_n_phase(np, torch, K, telemetry, space, objective, metric_objective,
                  constrained, paper, card, checked_buckets, big_chain) -> dict:
    """Phase 9, the rest of the engine on the card, at the paper's engine
    configuration: (j) the large-n job — a store preloaded with 100,000
    seeded observations, the subset posterior backend at its defaults
    (n_switch 2048, max_inducing 1024), 4 slots under the constant liar, two
    boundary refits — with per-decision breakdowns; (k) a constrained job
    with a GPHP chain and a factor per head (``per_head_gphp``); (l) the
    wire: one engine replica a real subprocess on the card
    (``python -m repro_torch.distributed.engine_server --port 0``), one
    in-process, a 24-trial ``Tuner(service=RemoteService(...))`` through
    both with the subprocess SIGKILLed mid-stream, then (j)'s job failing
    over the same way (a chunked-snapshot restore of its 100,000-row store,
    then the replay). Returns each path's launch counts, by kernel."""
    import signal
    import threading

    from repro_torch.core import (
        BOConfig, BOSuggester, SelectionService, ServiceConfig, Tuner,
        TuningJobConfig, WarmStartPool,
    )
    from repro_torch.core.scheduler import SimBackend
    from repro_torch.distributed import EngineServer, RemoteService
    from repro_torch.kernels.acq_score import ops as acq_ops

    print(f"phase 9 on {card}", flush=True)
    dev = torch.device("cuda")
    out = {}
    procs = []

    def table_of(res):
        return np.stack([space.encode(t.config) for t in res.trials])

    def full_table(res):
        return [(t.trial_id, t.config, str(t.state), t.objective, t.attempts)
                for t in res.trials]

    def spawn_replica(*flags):
        """An engine replica as a real subprocess on the card; its address
        is read from the first line it prints."""
        env = dict(os.environ)
        env.pop("REPRO_TELEMETRY", None)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (os.path.join(HERE, "src"), env.get("PYTHONPATH", "")) if p)
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.distributed.engine_server", "--port", "0",
             *flags],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=HERE)
        procs.append(proc)
        return proc

    def replica_address(proc):
        banner = proc.stdout.readline()
        if "listening on" not in banner:
            fail(f"engine replica subprocess did not start: {banner!r}")
        print(f"  replica subprocess {proc.pid}: {banner.strip()}", flush=True)
        # keep its pipe drained so the replica never blocks on a full pipe
        threading.Thread(target=proc.stdout.read, daemon=True).start()
        host, port = banner.split("listening on", 1)[1].split()[0].rsplit(":", 1)
        return (host, int(port))

    def appended_rows(spans):
        """Store rows folded into a factor by rank-1 appends — new rows and
        the replay of a rebuild, per factor (the objective's, each head's):
        one ``matern52_cross`` launch each."""
        total = 0
        for e in spans:
            a = e["attrs"]
            if e["name"] == "suggest.rank1_append":
                total += a["new"]
            elif e["name"] == "suggest.factor_rebuild" and "heads" not in a:
                total += a["n"] - a["boundary"]
            elif e["name"] == "suggest.head_append":
                total += a["new"] * a["heads"]
            elif e["name"] == "suggest.head_rebuild":
                total += (a["n"] - a["boundary"]) * a["heads"]
        return total

    def kill_after(proc, after, killed):
        def callback(tuner, trial):
            done = sum(1 for t in tuner.trials.values() if t.is_terminal)
            if done == after and proc.poll() is None:
                proc.send_signal(signal.SIGKILL)
                proc.wait()
                killed.append(done)
        return callback

    # the row buckets every acq_score launch scores (its factor's rows)
    scored = []
    real_acq = acq_ops.acq_score

    def counting_acq(post, *args, **kwargs):
        scored.append(int(post.x_train.shape[0]))
        return real_acq(post, *args, **kwargs)

    # both replica subprocesses start now; they reach the card while (j)
    # and (k) run. A boundary decision of the large job (selection and a
    # 1024-row chain) outlasts the default 30 s lease, so its replicas
    # lease for LARGE_TTL.
    LARGE_TTL = 120.0
    proc_a, proc_b = spawn_replica(), spawn_replica("--lease-ttl", str(LARGE_TTL))
    try:
        # ------------------------------------------------- (j) large n
        N_STORE, TRIALS, SLOTS, REFIT = 100_000, 20, 4, 10
        t0 = time.perf_counter()
        srng = np.random.default_rng(2022)
        fleet = []
        for u in srng.random((N_STORE, space.encoded_dim)):
            c = space.decode(u)
            fleet.append((c, float(objective(c)[0][-1])))
        print(f"(j) store: {N_STORE} seeded observations ({N_STORE * space.encoded_dim * 8 / 1e6:.1f}"
              f" MB of encoded rows) made in {time.perf_counter() - t0:.1f} s; refit_every "
              f"{REFIT}: the first decision's boundary (n = {N_STORE}) and the one after "
              f"{REFIT} own observations, 2 boundary refits in {TRIALS} trials", flush=True)
        large_cfg = {
            b: BOConfig(**{**paper, "backend": b, "posterior_backend": "subset",
                           "refit_every": REFIT})
            for b in ("kernel", "torch")
        }

        def large_tuner(service, callbacks=()):
            pool = WarmStartPool()
            pool.add_parent(fleet, name="fleet")
            return Tuner(space, objective, None, SimBackend(), TuningJobConfig(
                max_trials=TRIALS, max_parallel=SLOTS, job_name="large", seed=0),
                warm_start=pool, service=service, callbacks=callbacks)

        def large_run(backend):
            svc = SelectionService(ServiceConfig(
                default_bo_config=large_cfg[backend], sibling_warm_start=False), device=dev)
            tuner = large_tuner(svc)
            handle = tuner._service_handle
            inner = handle.suggest_batch
            peaks_mib = []

            def measured(k):
                torch.cuda.reset_peak_memory_stats(dev)
                got = inner(k)
                torch.cuda.synchronize(dev)
                peaks_mib.append(torch.cuda.max_memory_allocated(dev) / 2 ** 20)
                return got

            handle.suggest_batch = measured
            telemetry.get().reset()
            telemetry.set_enabled(True)
            K.reset_launch_counts()
            scored.clear()
            acq_ops.acq_score = counting_acq
            t0 = time.perf_counter()
            try:
                res = tuner.run()
                torch.cuda.synchronize()
            finally:
                acq_ops.acq_score = real_acq
            wall = time.perf_counter() - t0
            launches = dict(K.LAUNCHES)
            events = telemetry.get().trace_events()
            telemetry.set_enabled(False)
            return tuner, res, launches, events, peaks_mib, wall, list(scored)

        tuner, res, launches, events, peaks_mib, wall, buckets = large_run("kernel")
        done = res.trials
        if len(done) != TRIALS or any(t.state != "COMPLETED" for t in done):
            fail(f"(j) large n: {len(done)} trials, not {TRIALS} completed")
        cache = tuner.suggester.cache
        if cache.inducing_sel is None or len(cache.inducing_sel) != 1024:
            fail("(j) large n: the subset backend is not live with 1024 inducing rows")
        spans = [e for e in events if e.get("kind") == "span"]
        by_id = {e["span_id"]: e for e in spans}

        def decision_of(ev):
            up = by_id.get(ev["parent_id"])
            while up is not None and up["name"] != "suggest.decide":
                up = by_id.get(up["parent_id"])
            return None if up is None else up["span_id"]

        decides = sorted((e for e in spans if e["name"] == "suggest.decide"),
                         key=lambda e: e["t0"])
        parts = {e["span_id"]: {} for e in decides}
        chains = {}
        for ev in events:
            did = decision_of(ev)
            if did is None:
                continue
            if ev.get("kind") == "span":
                parts[did][ev["name"]] = parts[did].get(ev["name"], 0.0) + ev["dur"] * 1e3
            elif ev["name"] == "gphp.slice_chain":
                chains.setdefault(did, []).append(ev["attrs"])
        names = ("suggest.select_inducing", "suggest.gphp_fit", "suggest.factorize",
                 "suggest.factor_rebuild", "suggest.rank1_append", "suggest.acq_opt")
        if len(peaks_mib) != len(decides):
            fail(f"(j) large n: {len(peaks_mib)} measured decisions for {len(decides)} spans")
        for i, e in enumerate(decides):
            a, p = e["attrs"], parts[e["span_id"]]
            chain_text = "; ".join(
                f"chain {c['evaluations']} evaluations, NaN factors {c['nan_factors']}, "
                f"exhausted shrinks {c['exhausted']}, rounds {c['rounds']}, rows {c['rows']}"
                for c in chains.get(e["span_id"], ())) or "no refit"
            print(f"  (j) decision {i}: n={a['n']} k={a['k']} pending={a['pending']}: "
                  f"{e['dur'] * 1e3:.2f} ms; " + ", ".join(
                      f"{k.split('.', 1)[1]} {p.get(k, 0.0):.2f} ms" for k in names)
                  + f"; {chain_text}; peak device memory {peaks_mib[i]:.0f} MiB", flush=True)
        total = sum(e["dur"] for e in decides) * 1e3
        share = {k: sum(parts[e["span_id"]].get(k, 0.0) for e in decides) for k in names}
        print(f"(j) large n: {TRIALS} trials, {len(decides)} GP decisions in {wall:.1f} s "
              f"(engine {total:.1f} ms); shares of engine time: " + ", ".join(
                  f"{k.split('.', 1)[1]} {v / total:.1%}" for k, v in share.items())
              + f"; decision p50 {statistics.median(e['dur'] * 1e3 for e in decides):.2f} ms;"
              f" best {res.best_objective:.6f}; phase 2's paper chain: "
              + ", ".join(f"{n} rows {ms:.1f} ms" for n, ms in big_chain.items())
              + f"; {card}", flush=True)
        refits = sum(1 for e in spans if e["name"] == "suggest.gphp_fit")
        n_chains = sum(len(v) for v in chains.values())
        if refits != 2 or launches["slice_chain"] != refits or n_chains != refits:
            fail(f"(j) large n: {launches['slice_chain']} slice_chain launches and "
                 f"{n_chains} chains for {refits} refits (2 expected)")
        factorized = sum(1 for e in spans if e["name"] in ("suggest.factorize",
                                                           "suggest.factor_rebuild"))
        if launches["matern52_operand"] != factorized:
            fail(f"(j) large n: {launches['matern52_operand']} matern52_operand launches "
                 f"for {factorized} factorizations")
        picks = sum(e["attrs"]["k"] - 1 for e in decides)
        with_pending = sum(e["attrs"]["pending"] > 0 for e in decides)
        appended = appended_rows(spans)
        print(f"  (j) matern52_cross: {launches['matern52_cross']} launches for "
              f"{with_pending} pending sets, {picks} interim picks and {appended} store "
              f"rows appended", flush=True)
        if launches["matern52_cross"] != with_pending + picks + appended:
            fail(f"(j) large n: {launches['matern52_cross']} matern52_cross launches, not "
                 f"one a pending set, interim pick and appended row "
                 f"({with_pending + picks + appended})")
        seen = sorted(set(buckets))
        print(f"  (j) launches {launches}; acq_score row buckets {seen} "
              f"({len(buckets)} launches; held in phase 2: "
              f"{sorted(checked_buckets['acq_score'])})", flush=True)
        if not set(seen) <= checked_buckets["acq_score"] or not set(seen) <= {1024, 2048}:
            fail(f"(j) large n: acq_score scored buckets {seen}")
        if launches["acq_score"] != len(buckets) or not buckets:
            fail("(j) large n: acq_score launches and scored factors disagree")
        out["j"] = launches
        large_ref = res
        _, res_t, _, _, _, wall_t, _ = large_run("torch")
        got, want = table_of(res), table_of(res_t)
        diff = float(np.abs(got - want).max()) if got.shape == want.shape else math.inf
        print(f"  (j) kernel vs torch scoring: trial tables max |Δ| {diff:.3e} (tol 1e-9); "
              f"torch-scored run {wall_t:.1f} s", flush=True)
        if diff > 1e-9:
            fail("(j) large n: the trial table moves with the scoring backend")

        # ------------------------------------------- (k) per-head chains
        def per_head(backend):
            cfg = BOConfig(**{**paper, "backend": backend, "per_head_gphp": True})
            telemetry.get().reset()
            telemetry.set_enabled(True)
            K.reset_launch_counts()
            t0 = time.perf_counter()
            res = Tuner(space, metric_objective, BOSuggester(space, cfg, seed=0), SimBackend(),
                        TuningJobConfig(max_trials=24, max_parallel=4,
                                        metrics=constrained)).run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(K.LAUNCHES)
            spans = [ev for ev in telemetry.get().trace_events() if ev.get("kind") == "span"]
            telemetry.set_enabled(False)
            return res, launches, spans, wall

        res, launches, spans, wall = per_head("kernel")
        count = {}
        for ev in spans:
            count[ev["name"]] = count.get(ev["name"], 0) + 1
        attrs = [ev["attrs"] for ev in spans if ev["name"] == "suggest.decide"]
        gp_ms = [ev["dur"] * 1e3 for ev in spans
                 if ev["name"] == "suggest.decide" and ev["attrs"]["n"] >= 3]
        refits, head_fits = count.get("suggest.gphp_fit", 0), count.get("suggest.head_gphp_fit", 0)
        gp = [a for a in attrs if a["n"] >= 3]
        picks = sum(a["k"] - 1 for a in gp)
        with_pending = sum(a["pending"] > 0 for a in gp)
        factorized = sum(count.get(k, 0) for k in (
            "suggest.factorize", "suggest.factor_rebuild", "suggest.head_factorize",
            "suggest.head_rebuild"))
        print(f"(k) per-head constrained: 24 trials in {wall:.1f} s, {count.get('suggest.posterior', 0)}"
              f" GP decisions (p50 {statistics.median(gp_ms):.2f} ms), {refits} refits, "
              f"{head_fits} head refits; launches {launches};"
              f" best {res.best_objective:.6f}; {card}", flush=True)
        if not refits or head_fits != refits or launches["slice_chain"] != 2 * refits:
            fail(f"(k) per-head: {launches['slice_chain']} slice_chain launches for "
                 f"{refits} refits (2 a refit expected)")
        if launches["acq_score_multi"] != 0 or launches["acq_score"] != 0:
            fail("(k) per-head: a fused scoring kernel ran; per-head scoring is the "
                 "torch composition")
        if launches["matern52_operand"] != factorized:
            fail(f"(k) per-head: {launches['matern52_operand']} matern52_operand launches "
                 f"for {factorized} factorizations")
        want_cross = 2 * (with_pending + picks) + appended_rows(spans)
        if launches["matern52_cross"] != want_cross:
            fail(f"(k) per-head: {launches['matern52_cross']} matern52_cross launches, not "
                 f"one a pending set, interim pick and appended row per factor "
                 f"({want_cross})")
        out["k"] = launches
        res_t, _, _, _ = per_head("torch")
        diff = float(np.abs(table_of(res) - table_of(res_t)).max())
        print(f"  (k) kernel vs torch scoring: max |Δ| {diff:.3e} (tol 1e-9)", flush=True)
        if diff > 1e-9:
            fail("(k) per-head: the trial table moves with the scoring backend")

        # ------------------------------------------------------ (l) wire
        small_cfg = BOConfig(**paper)

        def small_tuner(service, callbacks=()):
            return Tuner(space, objective, None, SimBackend(), TuningJobConfig(
                max_trials=24, max_parallel=4, job_name="wire", seed=7),
                service=service, callbacks=callbacks)

        ref = small_tuner(SelectionService(ServiceConfig(default_bo_config=small_cfg),
                                           device=dev)).run()
        addr_a, addr_b = replica_address(proc_a), replica_address(proc_b)

        def over_the_wire(label, proc, addr, make_tuner, cfg, after, want, ttl=30.0,
                          **rs_kw):
            local = EngineServer(lease_ttl=ttl).start()
            killed = []
            telemetry.get().reset()
            telemetry.set_enabled(True)
            K.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                res = make_tuner(RemoteService([addr, local.address], bo_config=cfg, **rs_kw),
                                 callbacks=[kill_after(proc, after, killed)]).run()
                torch.cuda.synchronize()
            finally:
                local.shutdown()
            wall = time.perf_counter() - t0
            launches = dict(K.LAUNCHES)
            counters = telemetry.get().metrics()["counters"]
            telemetry.set_enabled(False)
            same = full_table(res) == full_table(want)
            print(f"(l) {label}: {len(res.trials)} trials in {wall:.1f} s, subprocess "
                  f"replica SIGKILLed after {killed} terminal trials; failovers "
                  f"{counters.get('client.failover', 0)}, re-adoptions "
                  f"{counters.get('client.readopt', 0)}, replayed ops "
                  f"{counters.get('client.oplog.replayed_ops', 0)}; failed attempts "
                  f"{res.num_failed_attempts}; trial table equal to the in-process run: "
                  f"{same}; in-process replica launches {launches}; {card}", flush=True)
            if not killed:
                fail(f"(l) {label}: the replica was never killed")
            if not same or res.num_failed_attempts != 0 or any(t.attempts != 1 for t in res.trials):
                fail(f"(l) {label}: the stream after failover differs from the in-process run")
            return launches

        out["l"] = over_the_wire("24-trial job", proc_a, addr_a, small_tuner, small_cfg, 8, ref,
                                 snapshot_every=4)
        launches = over_the_wire(
            "large-n job (100,000-row store)", proc_b, addr_b, large_tuner,
            large_cfg["kernel"], 13, large_ref, ttl=LARGE_TTL, snapshot_every=16,
            snapshot_frame_bytes=1 << 20)
        out["l"] = {k: out["l"][k] + launches[k] for k in launches}
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    return out


def make_check(torch, peaks, floor_ms: float, results: dict):
    """The kernel phases' ``check``: a kernel against its plain version on
    the same inputs (max error, or the gap of norms with ``measure="norm"``,
    against its tolerance), both timed beside the card's least time for
    the work (``peaks``) and the launch floor; at the main path's shape the
    numbers go into ``results`` for the JSON line. Fails on a disagreement
    or a bound the kernel beats."""

    def check(kname, dt, label, kfn, pfn, nbytes, flops, main_shape, tol=None,
              library=None, measure=None):
        got = kfn()
        torch.cuda.synchronize()
        want = pfn()
        torch.cuda.synchronize()
        if got.shape != want.shape:
            fail(f"{kname} {label}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
        if not torch.isfinite(got).all():
            fail(f"{kname} {label}: non-finite kernel output")
        delta = (got.double() - want.double()).abs()
        err = float(delta.max())
        elem = TOL_ELEM.get((kname, dt)) if tol is None else None
        if measure == "norm":  # the gap of norms, ||Δ|| / ||plain||
            gap = float(torch.linalg.vector_norm(got.double() - want.double())
                        / torch.linalg.vector_norm(want.double()))
            ok = gap <= tol
            tol_text = f"||Δ|| / ||plain|| {gap:.3e}, tol {tol:.0e}"
        elif measure == "abs":
            ok = err <= tol
            tol_text = f"tol {tol:.0e} absolute"
        elif elem is not None:
            rel, floor = elem
            limit = rel * want.double().abs() + floor
            worst = float((delta / limit).max())
            ok = worst <= 1.0
            tol_text = (f"per element |Δ| <= {rel:.3g}·|plain| + {floor:.3g}, "
                        f"worst {worst:.3f} of its limit")
        else:
            scale = max(1.0, float(want.abs().max()))
            tol = TOL[(kname, dt)] if tol is None else tol
            ok = err <= tol * scale
            tol_text = f"tol {tol:.0e} x {scale:.3g}"
        del delta
        k_ms = time_ms(torch, kfn)
        p_ms = time_ms(torch, pfn)
        call_ms = time_ms(torch, kfn, hide_host=False)
        b_ms, b_by = bound_ms(nbytes, flops, peaks)
        t_bytes, t_ops = bound_parts(nbytes, flops, peaks)
        # the rate of the resource that bounds the work, at kernel_ms
        rate = (f"{nbytes / k_ms / 1e6:.1f} GB/s" if b_by == "bytes"
                else f"{sum(flops.values()) / k_ms / 1e9:.2f} TFLOP/s, "
                     f"{nbytes / k_ms / 1e6:.1f} GB/s")
        floor_text = f" launch_floor_ms {floor_ms:.5f}" if k_ms <= 2 * floor_ms else ""
        print(f"{kname} {dt} {label}: max_abs_err {err:.3e} ({tol_text}) "
              f"kernel_ms {k_ms:.5f} ({rate}, {b_ms / k_ms:.1%} of bound: bytes "
              f"{t_bytes / k_ms:.1%}, operations {t_ops / k_ms:.1%}) "
              f"plain_ms {p_ms:.5f} bound_ms {b_ms:.6f} "
              f"({b_by}){floor_text} call_ms {call_ms:.5f} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail(f"{kname} {dt} {label} disagrees with its plain version")
        if b_ms > k_ms:
            fail(f"{kname} {dt} {label}: {b_ms / k_ms:.1%} of its bound — the bound is "
                 "priced wrong (more work than the card can do in that time)")
        lib_ms = None
        if library is not None:
            lib_ms = time_ms(torch, library)
            lib_err = float((library().double() - want.double()).abs().max())
            print(f"  library call: {lib_ms:.5f} ms, max |Δ| to plain {lib_err:.3e}",
                  flush=True)
        if main_shape:
            results[kname] = {
                "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            }

    return check


def main() -> None:
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        fail(f"numpy/torch missing: {exc}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    # phase 10's restart check runs cuBLAS under deterministic algorithms,
    # which needs this set before CUDA initialises
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        from repro_torch import kernels as K
        from repro_torch.kernels import _build
        from repro_torch.launch.roofline import H100_SXM
    except ImportError as exc:
        fail(f"cannot import the port (run from a checkout's root): {exc}")
    PEAKS["SXM"].update(hbm=H100_SXM.hbm_bw, bf16=H100_SXM.peak_flops)

    # ------------------------------------------------------------ 1. setup
    t_phase = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    peaks = dict(PEAKS[part_of(name)])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    peaks["exp"] = 16 * sms * sm_clock_hz()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {name} {sms} SMs "
          f"peaks {part_of(name)} {peaks}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
    from repro_torch.core.gp.kernels import gram
    from repro_torch.kernels.matern52.kernel import (
        empty_kernel,
        matern52_cross_kernel,
        matern52_gram_kernel,
        matern52_operand_kernel,
    )
    from repro_torch.kernels.matern52.ops import packed_params
    from repro_torch.kernels.matern52.plain import (
        matern52_cross_plain,
        matern52_gram_plain,
        matern52_operand_plain,
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

    # The BO jobs' space and seeded objective (phases 2–5): an XGBoost-shaped
    # space; the final loss of a learning curve and a cost per trial.
    from repro_torch.core import (
        BOConfig, BOSuggester, Continuous, Integer, MetricSet, MetricSpec,
        SearchSpace, Tuner, TuningJobConfig, pareto_mask,
    )
    from repro_torch.core import prng, telemetry
    from repro_torch.core.gp.slice_sampler import (
        FAST_CONFIG, PAPER_CONFIG, SliceSamplerConfig, chain_draws, keep_rows,
    )
    from repro_torch.core.history import bucket_size
    from repro_torch.core.optimize_acq import AcqOptConfig
    from repro_torch.core.scheduler import SimBackend
    from repro_torch.kernels.slice_chain.kernel import slice_chain_kernel
    from repro_torch.kernels.slice_chain.plain import pack_table, slice_chain_plain

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

    results = {}  # kernel name -> numbers at the main path's shape
    # -------------------------------------------------------------- 2. kernels
    t_phase = time.perf_counter()
    # The launch floor: one empty kernel (matern52.cu), timed as every
    # kernel is. A kernel within twice it is bound by its launch, whatever
    # its bytes and operations bound says.
    floor_ms = time_ms(torch, empty_kernel)
    print(f"launch_floor_ms {floor_ms:.5f} (an empty kernel, <<<1, 1>>>)", flush=True)

    check = make_check(torch, peaks, floor_ms, results)

    # The scoring wrappers plan their launches (kernel.py::walk_plan) with a
    # mirror of the walk's shared-memory layout; hold it to the header's own
    # (acq_walk.cuh Layout) at every row bucket the engine makes, both
    # launch shapes, d up to 20 and both dtypes.
    from repro_torch.kernels.acq_score.kernel import walk_plan
    plans = 0
    for lib_name in ("acq_score", "acq_score_multi"):
        lib = _build.library(lib_name)
        limit = getattr(lib, f"{lib_name}_smem_limit")(0)
        header_bytes = getattr(lib, f"{lib_name}_smem_bytes")
        for m_ in (1024, 8):
            for n_ in [8 * 2**k for k in range(9)]:
                for dp, elem in ((8, 8), (24, 8), (8, 4), (24, 4)):
                    plan = walk_plan(10, m_, n_, dp, elem, sms, limit, lib_name)
                    if header_bytes(plan.ta, plan.bm, n_, dp, elem) != plan.smem:
                        fail(f"{lib_name}: walk_plan's shared memory {plan.smem} for "
                             f"{plan} (n={n_}, d={dp}, {elem}-byte) is not the header's "
                             f"{header_bytes(plan.ta, plan.bm, n_, dp, elem)}")
                    plans += 1
    print(f"walk plans: {plans} plans' shared memory equals acq_walk.cuh's layout "
          f"(limit {limit} bytes)", flush=True)

    # Work counts use the problem's own sizes (the live train rows, d
    # features), not the padded widths the packed inputs carry. Besides full
    # buckets, the cases (live, bucket) are padded the way the engine pads
    # the buckets the 64-trial main path reaches. The anchor grid is A =
    # 1024 anchors; the decision's second launch, the re-rank of the
    # num_refine = 8 refined points, is held at the main shape (A = 8); and
    # n = 2048 is the exact backend's largest bucket (n_switch).
    S = 10
    cases = ([(d, n, n, 1024) for d in (6, 20) for n in (64, 256, 1024)]
             + [(6, 5, 8, 1024), (6, 13, 16, 1024), (6, 27, 32, 1024), (6, 50, 64, 1024)]
             + [(6, 2048, 2048, 1024), (6, 64, 64, 8)]
             # the subset backend's factor (phase 9 (j)): 1024 inducing rows
             # plus appends and fantasies, in the 2048 bucket
             + [(6, 1030, 2048, 1024)])
    # row buckets held against the plain version, per scoring kernel; each
    # job of phases 4–5 must stay within its kernel's
    checked_buckets = {"acq_score": {n for _, _, n, _ in cases}}
    for d, live, n, A in cases:
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
                main_shape=(dt == "f64" and live == n == 64 and d == 6 and A == 1024),
            )
        del post

    # acq_score_multi: every mode at the heads the multi-metric paths give
    # it (constrained 1 objective + 1 constraint; pareto 2 objectives + 1
    # constraint, W = 16 draws; rungs 4 heads; cost objective + log-cost),
    # at the shape buckets the 24-trial jobs of phase 5 reach — 8, 16 and
    # 32 rows, padded past the live rows as the engine pads them — and at
    # full buckets of 64 and 1024 rows; pareto and rungs also at the exact
    # backend's largest bucket (2048 rows), and pareto at the re-rank's 8
    # anchors on the main shape. The main path's shape, whose numbers the
    # JSON line reports, is the largest bucket the jobs reach.
    d, n_draws = 6, 16
    MULTI = {"constrained": (2, 1), "pareto": (3, 1), "rungs": (4, 0), "cost": (2, 0)}
    multi_main = (23, 32, 1024)
    multi_cases = ((7, 8, 1024), (13, 16, 1024), multi_main, (64, 64, 1024),
                   (1024, 1024, 1024), (2048, 2048, 1024), (23, 32, 8))
    multi_modes = {(2048, 1024): ("pareto", "rungs"), (32, 8): ("pareto",)}
    checked_buckets["acq_score_multi"] = {n for _, n, _ in multi_cases}
    for live, n, A in multi_cases:
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
            if mode not in multi_modes.get((n, A), MULTI):
                continue
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
                    main_shape=(dt == "f64" and (live, n, A) == multi_main
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
                nbytes, {"f32": flops}, main_shape=False,
            )
    # ... and at its path's shapes: a kriging-believer prediction of one
    # fantasy, K(X, x) for S = 10 samples over the buckets the 16-trial job
    # of phase 5 reaches (the JSON line's numbers: its largest)
    kb_base = P.default_params(d).pack().numpy()
    kb_params = P.GPHyperParams.unpack(torch.as_tensor(np.stack(
        [kb_base + 0.1 * rng.standard_normal(3 * d + 2) for _ in range(10)])).to(dev), d)
    pp, _ = packed_params(kb_params, True, torch.float32)
    for n in (8, 16):
        x1 = torch.as_tensor(rng.random((n, d)), dtype=torch.float32).to(dev)
        x2 = torch.as_tensor(rng.random((1, d)), dtype=torch.float32).to(dev)
        nbytes = 4 * ((n + 1) * d + 4 * 10 * d + 10 + 10 * n)
        flops = 10 * (n * (3 * d + 10) + (n + 1) * d * 12)
        check(
            "matern52_gram", "f32", f"S=10 n={n} m=1 d={d} (a prediction)",
            lambda: matern52_gram_kernel(x1, x2, *pp),
            lambda: matern52_gram_plain(x1, x2, *pp),
            nbytes, {"f32": flops}, main_shape=(n == 16),
        )
    # matern52_cross: the cross rows of the constant liar's 3 pending points
    # in one launch, from the engine's float64 rows and GPHP table (S = 10),
    # at the row buckets the jobs reach with their live rows (7 of 8 grows
    # to 16 on the way) and at 1024. Held against its plain version (2e-5)
    # and, bit for bit, against one launch a row as the sequential appends
    # make them (row r against the bucket after rows 0…r−1), on the columns
    # each append reads. Work: the live rows' and the pending rows' columns.
    S, R = 10, 3
    base = P.default_params(d).pack().numpy()
    packed = np.stack([base + 0.1 * rng.standard_normal(3 * d + 2) for _ in range(S)])
    table = torch.as_tensor(packed).to(dev)
    params = P.GPHyperParams.unpack(table, d)
    fold_cases = ((5, 8), (7, 8), (13, 16), (29, 32), (60, 64))
    # (1027, 2048): the subset job's appends against 1024 inducing rows plus
    # the appends since the boundary, in the 2048 bucket (phase 9 (j))
    for live, n in fold_cases + ((1021, 1024), (1027, 2048)):
        x_np = np.zeros((n, d))
        x_np[:live] = rng.random((live, d))
        xt = torch.as_tensor(x_np).to(dev)
        xn = torch.as_tensor(rng.random((R, d))).to(dev)
        m = max(n, bucket_size(live + R))
        rows = matern52_cross_kernel(xn, xt, table, live, m)
        seq_err, xs, seq = 0.0, xt, []
        for r in range(R):
            idx = live + r
            if idx >= xs.shape[0]:
                xs = torch.nn.functional.pad(xs, (0, 0, 0, bucket_size(idx + 1) - xs.shape[0]))
            seq.append((xn[r:r + 1], xs, idx))
            one = matern52_cross_kernel(xn[r:r + 1], xs, table, idx, xs.shape[0])
            seq_err = max(seq_err, float((one[:, 0, :idx] - rows[:, r, :idx]).abs().max()))
            xs = xs.clone()
            xs[idx] = xn[r]
        cols = live + R
        nbytes = 8 * (R * d + live * d + S * (3 * d + 2) + S * R * m)
        flops = S * (R * cols * (3 * d + 10) + (cols + R) * d * 12)
        label = f"S={S} R={R} m={m} live={live} d={d}"
        t_rows = time_ms(torch, lambda: [matern52_cross_kernel(a, b, table, i, b.shape[0])
                                        for a, b, i in seq])
        print(f"matern52_cross {label}: rows against {R} launches of one row max |Δ| "
              f"{seq_err:.3e} (must be 0); {R} one-row launches {t_rows:.5f} ms", flush=True)
        if seq_err != 0.0:
            fail(f"matern52_cross {label}: the rows launch differs from one launch a row")
        check(
            "matern52_cross", "f32", label,
            lambda: matern52_cross_kernel(xn, xt, table, live, m),
            lambda: matern52_cross_plain(xn, xt, table, live, m),
            nbytes, {"f32": flops}, main_shape=(live, n) == (60, 64),
        )

    # matern52_operand: the factorize step's operand in one launch, against
    # its plain version (2e-5) and, bit for bit, against the torch
    # composition it replaces (``gram(backend="kernel")`` — torch-packed
    # parameters, float32 casts, the gram launch, the cast back — and the
    # mask, eye and noise ops of ``masked_operand``), at the buckets the jobs
    # factorize and at 1024. Work: the gram in float32 (live block), the
    # epilogue in float64 (5 operations an entry).
    jitter = G._JITTER
    # (1024, 1024): the subset backend's factorize, 1024 inducing rows
    for live, n in ((5, 8), (13, 16), (29, 32), (60, 64), (1021, 1024), (1024, 1024)):
        x_np = np.zeros((n, d))
        x_np[:live] = rng.random((live, d))
        xt = torch.as_tensor(x_np).to(dev)
        mt = torch.as_tensor(np.arange(n) < live).to(dev)

        def composition():
            k = gram(xt, xt, params, backend="kernel")
            return G.masked_operand(k, mt, torch.exp(2.0 * params.log_noise) + jitter)

        got = matern52_operand_kernel(xt, table, mt, jitter)
        comp_err = float((got - composition()).abs().max())
        comp_ms = time_ms(torch, composition, hide_host=False)
        label = f"S={S} n={n} live={live} d={d}"
        print(f"matern52_operand {label}: against the torch composition max |Δ| "
              f"{comp_err:.3e} (must be 0); composition call_ms {comp_ms:.5f}", flush=True)
        if comp_err != 0.0:
            fail(f"matern52_operand {label}: differs from the torch composition")
        nbytes = 8 * (n * d + S * (3 * d + 2) + S * n * n) + n
        flops = {"f32": S * (live * live * (3 * d + 10) + 2 * live * d * 12),
                 "f64": S * n * n * 5}
        check(
            "matern52_operand", "f32", label,
            lambda: matern52_operand_kernel(xt, table, mt, jitter),
            lambda: matern52_operand_plain(xt, table, mt, jitter),
            nbytes, flops, main_shape=(live, n) == (60, 64),
        )

    # The engine's pending fold (constant liar, 3 pending, fit_backend
    # "kernel"): the set's rows from one launch, one rank-1 append a row,
    # against three appends that each launch their own row — the factor,
    # L⁻¹, rows, mask and α bit for bit, at every bucket 8–64.
    fold_engine = BOSuggester(space, BOConfig(fit_backend="kernel", pending_strategy="liar"),
                              seed=0, device=dev)
    for live, n in fold_cases:
        post, x_live = posterior(n, d, S, live)
        y0 = list(rng.standard_normal(live))
        xb = torch.as_tensor(rng.random((R, d))).to(dev)
        rows = fold_engine._pending_rows(post, xb, live)
        a, ya, b, yb = post, y0, post, y0
        for r in range(R):
            a, (ya,), _ = fold_engine._fantasy_append(a, [ya], xb[r], rows[..., r, :])
            b, (yb,), _ = fold_engine._fantasy_append(b, [yb], xb[r])
        errs = {key: float((getattr(a, key).double() - getattr(b, key).double()).abs().max())
                for key in ("chol", "chol_inv", "x_train", "mask", "alpha")}
        print(f"pending fold n={n} live={live} +{R} (bucket {a.x_train.shape[0]}): rows "
              f"launch against one launch a row, max |Δ| " + ", ".join(
                  f"{k} {v:.3e}" for k, v in errs.items()) + " (must be 0)", flush=True)
        if any(v != 0.0 for v in errs.values()):
            fail(f"pending fold n={n} live={live}: differs from the sequential fold")

    # slice_chain: one whole chain at the paper's configuration (300
    # updates, up to 8 step-outs a side and 32 shrinks each) against its
    # plain version on the same draw table — the host chain, which per
    # evaluation launches matern52_gram (f32 gram) or builds matern52_ard
    # (f64), factorizes with cuSOLVER and reads back one float. Data: seeded
    # configurations of the main path's space and their standardized
    # objective values, a few live rows under each row bucket the engine
    # makes up to 256 (8–128 keep the factor in shared memory, 256 in the
    # global workspace), from the engine's start and bounds; both gram
    # types. Then the main path's shape (f32 gram) from a start where the
    # float32 gram is indefinite — near-duplicate rows, amplitude near 20,
    # noise near 1e-4 (ROADMAP C10's stuck chain): every log density in the
    # box is NaN or below a NaN slice level, every shrink runs out, and the
    # plain chain makes its ~10,500 host evaluations in about 10 s. Held as
    # CHAIN_TOL / CHAIN_TIE say; the evaluation counts must be equal where
    # no branch differs. The kernel evaluates the chain's points in rounds
    # of up to W side by side; its rounds and the points it evaluated (some
    # thrown away) are printed beside the chain's own counts. The main
    # path's shape is its largest bucket (60 of 64 rows) with its f32 gram.
    # Bound: this run's work at the card's peaks — per evaluation of the
    # chain in the box (the kernel's count), the gram (m(m+1)/2 entries ×
    # (3d + 10) operations and the warp, 12 per live row and feature) in the
    # gram's type, and the factor with y as an extra row (m³/3 + m² f64) —
    # against the bytes (x, y, mask, the table and the kept samples once).
    # The points the rounds evaluate and throw away are not counted: the
    # bound is the chain's work. The chain's decisions are serial, and a
    # round runs on W SMs: the W-SM bound (each type's peak over the SM
    # count, times W) is printed beside it. No PyTorch call computes a
    # chain.
    from repro_torch.kernels.slice_chain.plain import host_log_density

    chain_cfg = PAPER_CONFIG
    d = space.encoded_dim
    dim = P.GPHyperParams.packed_size(d)
    chain_bounds = P.default_bounds(d, space.warpable_dims())
    chain_z0 = np.clip(P.default_params(d).pack().numpy(),
                       chain_bounds.lower + 1e-4, chain_bounds.upper - 1e-4)
    crng = np.random.default_rng(16)
    ties = 0
    # the 1024-row chain held against the plain chain: this many updates
    BIG_SHORT = SliceSamplerConfig(num_samples=40, burn_in=30, thin=1)
    big_chain = {}  # n -> ms of the paper chain (phase 9 prints it beside its own)

    def chain_case(label, x_np, y_np, live, z0, key, gram, main_shape=False,
                   chain_cfg=chain_cfg):
        nonlocal ties
        n = x_np.shape[0]
        draws = chain_draws(key, dim, chain_cfg)
        xt, yt = torch.as_tensor(x_np).to(dev), torch.as_tensor(y_np).to(dev)
        mt = torch.as_tensor(np.arange(n) < live).to(dev)
        table = torch.as_tensor(pack_table(chain_bounds, z0, draws)).to(dev)
        kept_k, counts_k, tr_k, sched = slice_chain_kernel(xt, yt, mt, table, chain_cfg, gram,
                                                            trace=True, schedule=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kept_p, counts_p, tr_p = slice_chain_plain(xt, yt, mt, table, chain_cfg, gram,
                                                   trace=True)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        ck, cp = counts_k.cpu().numpy(), counts_p.cpu().numpy()
        made, rounds, width = (int(v) for v in sched.cpu().numpy())
        if kept_k.shape != kept_p.shape or not torch.isfinite(kept_k).all():
            fail(f"{label}: kept samples of shape {tuple(kept_k.shape)}, or not finite")
        div = chain_divergence(tr_k[: int(ck[0])].cpu().numpy(), tr_p.cpu().numpy(),
                               draws.levels)
        held = np.ones(chain_cfg.num_kept, dtype=bool)
        tie_text = "every branch alike"
        if div is not None:
            e, update, tie = div
            if not tie:
                fail(f"{label}: evaluation {e} (update {update}) takes another "
                     "branch than the plain chain, and not on a near-tie")
            ties += 1
            held = keep_rows(chain_cfg) < update
            tie_text = (f"near-tie at evaluation {e} (update {update}): held "
                        f"{int(held.sum())} of {chain_cfg.num_kept} kept rows")
        held_t = torch.as_tensor(held, device=dev)
        err = float((kept_k - kept_p).abs()[held_t].max()) if held.any() else 0.0
        if err > CHAIN_TOL:
            fail(f"{label}: kept samples differ by {err:.3e} from the plain chain")
        if div is None and not np.array_equal(ck, cp):
            fail(f"{label}: counts {ck.tolist()} against the plain chain's {cp.tolist()}")
        k_ms = time_ms(torch, lambda: slice_chain_kernel(xt, yt, mt, table, chain_cfg, gram),
                       reps=3 if n <= 64 else 1, warmup=0)
        m, boxed = live, float(ck[3])
        gram_ops = boxed * (m * (m + 1) // 2 * (3 * d + 10) + 12 * m * d)
        factor_ops = boxed * (m ** 3 / 3 + m * m)
        flops = ({"f32": gram_ops, "f64": factor_ops} if gram == torch.float32
                 else {"f64": gram_ops + factor_ops})
        nbytes = 8 * (n * d + n) + n + 8 * table.numel() + 8 * (kept_k.numel() + 4)
        b_ms, b_by = bound_ms(nbytes, flops, peaks)
        w_ms = sum(f / (peaks[u] / sms * width) for u, f in flops.items()) * 1e3
        print(f"{label}: kept max |Δ| {err:.3e} (tol {CHAIN_TOL:.0e}; {tie_text}); "
              f"evaluations {int(ck[0])} (plain {int(cp[0])}), NaN factors {int(ck[1])}, "
              f"exhausted shrinks {int(ck[2])}, in the box {int(ck[3])}; W {width}, rounds "
              f"{rounds} ({rounds / chain_cfg.num_samples:.2f} an update), points evaluated "
              f"{made}; kernel_ms {k_ms:.5f} ({k_ms / rounds * 1e3:.3f} us a round, "
              f"{b_ms / k_ms:.4%} of bound) plain_ms {p_ms:.5f} bound_ms {b_ms:.6f} "
              f"({b_by}) {width}-SM bound {w_ms:.5f} ms; library none", flush=True)
        if main_shape:
            results["slice_chain"] = {
                "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            }
        return ck

    chain_cases = ((5, 8), (13, 16), (29, 32), (60, 64), (124, 128), (250, 256))
    for live, n in chain_cases:
        configs = [space.decode(u) for u in crng.random((live, d))]
        x_np = np.zeros((n, d))
        x_np[:live] = np.stack([space.encode(c) for c in configs])
        y_live = np.array([objective(c)[0][-1] for c in configs])
        y_np = np.zeros(n)
        y_np[:live] = (y_live - y_live.mean()) / y_live.std()
        for dt, gram in (("f32", torch.float32), ("f64", torch.float64)):
            chain_case(f"slice_chain {dt} T={chain_cfg.num_samples} n={n} live={live} d={d}",
                       x_np, y_np, live, chain_z0, prng.PRNGKey(n), gram,
                       main_shape=(dt == "f32" and n == 64))
    # the indefinite start at the main path's shape
    live, n = 60, 64
    irng = np.random.default_rng(64)
    x_np = np.zeros((n, d))
    x_np[:live] = (np.repeat(irng.random((live // 3, d)), 3, axis=0)
                   + 1e-4 * irng.random((live, d)))
    y_live = irng.standard_normal(live)
    y_np = np.zeros(n)
    y_np[:live] = (y_live - y_live.mean()) / y_live.std()
    z0 = chain_z0.copy()
    z0[d] = chain_bounds.upper[d] - 1e-4  # amplitude near 20
    z0[d + 1] = chain_bounds.lower[d + 1] + 1e-4  # noise near 1e-4
    box = (chain_bounds.lower, chain_bounds.upper, chain_bounds.center,
           np.maximum(chain_bounds.width / 4.0, 1e-6))
    g_start = host_log_density(torch.as_tensor(x_np).to(dev), torch.as_tensor(y_np).to(dev),
                               torch.as_tensor(np.arange(n) < live).to(dev), box,
                               torch.float32)(z0)
    if not math.isnan(g_start):
        fail(f"slice_chain indefinite case: g at the start is {g_start}, not NaN")
    ck = chain_case(f"slice_chain f32 T={chain_cfg.num_samples} n={n} live={live} d={d} "
                    "indefinite start", x_np, y_np, live, z0, prng.PRNGKey(65), torch.float32)
    if int(ck[2]) != chain_cfg.num_samples:
        fail(f"slice_chain indefinite case: {int(ck[2])} exhausted shrinks, not "
             f"{chain_cfg.num_samples}")
    # (i) the subset backend's shapes (phase 9): the paper's chain on 512
    # and 1024 live rows (the default max_inducing) with the f32 gram, the
    # factor in each block's global workspace. Each is timed once, with
    # its cluster width W, rounds and evaluations; the 512-row chain is
    # then held against the plain chain in full (chain_case), the 1024-row
    # one on a chain shortened to BIG_SHORT's updates (the host chain makes
    # one cuSOLVER factorization and one read-back an evaluation).
    for n in (512, 1024):
        configs = [space.decode(u) for u in crng.random((n, d))]
        x_np = np.stack([space.encode(c) for c in configs])
        y_live = np.array([objective(c)[0][-1] for c in configs])
        y_np = (y_live - y_live.mean()) / y_live.std()
        xt, yt = torch.as_tensor(x_np).to(dev), torch.as_tensor(y_np).to(dev)
        mt = torch.ones(n, dtype=torch.bool, device=dev)
        draws = chain_draws(prng.PRNGKey(n), dim, chain_cfg)
        table = torch.as_tensor(pack_table(chain_bounds, chain_z0, draws)).to(dev)
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        ev0.record()
        kept_k, counts_k, _, sched = slice_chain_kernel(xt, yt, mt, table, chain_cfg,
                                                        torch.float32, schedule=True)
        ev1.record()
        torch.cuda.synchronize()
        k_ms = ev0.elapsed_time(ev1)
        ck = counts_k.cpu().numpy()
        made, rounds, width = (int(v) for v in sched.cpu().numpy())
        if not torch.isfinite(kept_k).all():
            fail(f"slice_chain n={n}: kept samples not finite")
        boxed = float(ck[3])
        flops = {"f32": boxed * (n * (n + 1) // 2 * (3 * d + 10) + 12 * n * d),
                 "f64": boxed * (n ** 3 / 3 + n * n)}
        nbytes = 8 * (n * d + n) + n + 8 * table.numel() + 8 * (kept_k.numel() + 4)
        b_ms, b_by = bound_ms(nbytes, flops, peaks)
        w_ms = sum(f / (peaks[u] / sms * width) for u, f in flops.items()) * 1e3
        big_chain[n] = k_ms
        print(f"slice_chain f32 T={chain_cfg.num_samples} n={n} live={n} d={d} (paper "
              f"chain, subset shape): kernel_ms {k_ms:.3f} ({k_ms / rounds * 1e3:.3f} us a "
              f"round); evaluations {int(ck[0])}, NaN factors {int(ck[1])}, exhausted "
              f"shrinks {int(ck[2])}, in the box {int(ck[3])}; W {width}, rounds {rounds} "
              f"({rounds / chain_cfg.num_samples:.2f} an update), points evaluated {made}; "
              f"bound_ms {b_ms:.6f} ({b_by}, {b_ms / k_ms:.4%} of bound) {width}-SM bound "
              f"{w_ms:.5f} ms; {card}", flush=True)
        held_cfg = chain_cfg if n == 512 else BIG_SHORT
        t0 = time.perf_counter()
        chain_case(f"slice_chain f32 T={held_cfg.num_samples} n={n} live={n} d={d} "
                   f"against plain ({held_cfg.num_samples} updates)", x_np, y_np, n,
                   chain_z0, prng.PRNGKey(n + 1), torch.float32, chain_cfg=held_cfg)
        print(f"  held against the plain chain with {held_cfg.num_samples} updates in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    n_chains = 2 * len(chain_cases) + 3
    print(f"slice_chain: {ties} of {n_chains} chains ended on a near-tie "
          f"(at most {CHAIN_MAX_TIES})", flush=True)
    if ties > CHAIN_MAX_TIES:
        fail(f"slice_chain: {ties} chains ended on a near-tie")
    phase_done("2 kernels", t_phase)

    # ------------------------------------------------------- 3. invariance
    t_phase = time.perf_counter()

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

    def run_job(cfg, trials, parallel, fn=objective, tuner_kw=None, **job):
        sugg = BOSuggester(space, cfg, seed=0)
        tuner = Tuner(space, fn, sugg, SimBackend(),
                      TuningJobConfig(max_trials=trials, max_parallel=parallel, **job),
                      **(tuner_kw or {}))
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

    def drive(label, cfg, trials, parallel, scorer, fn=objective, tuner_kw=None,
              stopped_ok=False, **job):
        """One job with spans on and launch counts set to 0 just before it;
        checks the trials (completed, or stopped early when ``stopped_ok``),
        the launches of ``scorer``, ``slice_chain`` (once
        per refit), ``matern52_operand`` (once per factorization or replayed
        rebuild),
        ``matern52_cross`` (once per GP decision with pending trials, once
        per interim pick) and, for the kriging believer, ``matern52_gram``
        (once per fantasy), and that the row buckets it scored were held
        against the plain version in phase 2; prints the decision latency
        and the slowest GP decision's breakdown."""
        kb = cfg.pending_strategy == "kb"
        must_launch = (scorer, "matern52_operand", "matern52_cross", "slice_chain") + (
            ("matern52_gram",) if kb else ())
        telemetry.get().reset()
        telemetry.set_enabled(True)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        tuner, res = run_job(cfg, trials, parallel, fn, tuner_kw, **job)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        telemetry.set_enabled(False)

        done = res.trials
        ended = ("COMPLETED", "STOPPED") if stopped_ok else ("COMPLETED",)
        if not done or any(t.state not in ended for t in done):
            fail(f"{label}: {len(done)} trials, not all {' or '.join(ended).lower()}")
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
        chains = []  # the gphp.slice_chain events: one per refit
        for ev in telemetry.get().trace_events():
            if ev.get("kind") == "span":
                spans.setdefault(ev["name"], []).append(ev["dur"] * 1e3)
                by_id[ev["span_id"]] = ev
            elif ev.get("name") == "gphp.slice_chain":
                chains.append(ev)
        decisions = len(spans.get("suggest.posterior", []))
        refits = len(spans.get("suggest.gphp_fit", []))
        if launches["slice_chain"] != refits or len(chains) != refits:
            fail(f"{label}: {launches['slice_chain']} slice_chain launches and "
                 f"{len(chains)} chains for {refits} refits")
        factorized = len(spans.get("suggest.factorize", [])) + len(
            spans.get("suggest.factor_rebuild", []))
        if launches["matern52_operand"] != factorized:
            fail(f"{label}: {launches['matern52_operand']} matern52_operand launches "
                 f"for {factorized} factorizations and rebuilds")

        def med(span_name):
            v = spans.get(span_name)
            return f"{statistics.median(v):.2f} ms (n={len(v)})" if v else "none"

        # Decision latency is over GP decisions: the suggest.decide spans
        # that enclose a suggest.posterior span (cold-start decisions run
        # no GP).
        def decision_of(ev):
            """The span id of the suggest.decide span enclosing ``ev``."""
            up = by_id.get(ev["parent_id"])
            while up is not None and up["name"] != "suggest.decide":
                up = by_id.get(up["parent_id"])
            return None if up is None else up["span_id"]

        gp_ids = {decision_of(ev) for ev in by_id.values()
                  if ev["name"] == "suggest.posterior"} - {None}
        dec = sorted(by_id[i]["dur"] * 1e3 for i in gp_ids)
        # Cross rows: one launch per GP decision with pending trials (the
        # whole set), one per interim pick of a batch; a launch a pending
        # trial before the rows entry. The kriging believer predicts each
        # fantasy: one matern52_gram launch each.
        attrs = [by_id[i]["attrs"] for i in gp_ids]
        picks = sum(a["k"] - 1 for a in attrs)
        with_pending = sum(a["pending"] > 0 for a in attrs)
        fantasies = sum(a["pending"] for a in attrs) + picks
        want_cross = with_pending + picks
        print(f"  matern52_cross: {launches['matern52_cross']} launches for {len(attrs)} GP "
              f"decisions ({with_pending} with pending trials, {fantasies} fantasies, "
              f"{picks} interim picks): expected {want_cross}, one a pending trial would "
              f"be {fantasies}", flush=True)
        if launches["matern52_cross"] != want_cross:
            fail(f"{label}: {launches['matern52_cross']} matern52_cross launches, not "
                 f"{want_cross}")
        if launches["matern52_gram"] != (fantasies if kb else 0):
            fail(f"{label}: {launches['matern52_gram']} matern52_gram launches, not "
                 f"{fantasies if kb else 0}")
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
        evals = [c["attrs"]["evaluations"] for c in chains]
        rounds = [c["attrs"]["rounds"] for c in chains]
        stuck = sum(c["attrs"]["exhausted"] == PAPER_CONFIG.num_samples for c in chains)
        print(f"  chains: {refits}, evaluations per chain median "
              f"{statistics.median(evals):.0f} (min {min(evals)}, max {max(evals)}), rounds "
              f"median {statistics.median(rounds):.0f} (max {max(rounds)}, W "
              f"{chains[0]['attrs']['width']}); "
              f"NaN factors {sum(c['attrs']['nan_factors'] for c in chains)}, "
              f"exhausted shrinks {sum(c['attrs']['exhausted'] for c in chains)} in all; "
              f"{stuck} chains never moved (every shrink ran out)", flush=True)

        # the slowest GP decision: its rows, its chain, its spans (C10)
        slow = max(gp_ids, key=lambda i: by_id[i]["dur"])
        slow_ms = by_id[slow]["dur"] * 1e3
        n_slow = max(ev["attrs"]["n"] for ev in by_id.values()
                     if ev["name"] == "suggest.posterior" and decision_of(ev) == slow)
        parts = {}
        for ev in by_id.values():
            if ev["name"] in ("suggest.gphp_fit", "suggest.factorize", "suggest.acq_opt") \
                    and decision_of(ev) == slow:
                parts[ev["name"]] = parts.get(ev["name"], 0.0) + ev["dur"] * 1e3
        own = [c["attrs"] for c in chains if decision_of(c) == slow]
        chain_text = ("no refit" if not own else ", ".join(
            f"evaluations {a['evaluations']}, NaN factors {a['nan_factors']}, exhausted "
            f"shrinks {a['exhausted']}, in the box {a['in_box']}, rounds {a['rounds']}, "
            f"points evaluated {a['made']}, start amplitude "
            f"{math.exp(a['start_log_amplitude']):.4g} noise std "
            f"{math.exp(a['start_log_noise']):.4g}" for a in own))
        print(f"  slowest GP decision: {slow_ms:.2f} ms ({slow_ms / statistics.median(dec):.2f}"
              f"x the p50), n={n_slow}, row bucket {bucket_size(n_slow)}; chain: "
              f"{chain_text}; spans: " + ", ".join(
                  f"{k} {parts.get(k, 0.0):.2f} ms" for k in
                  ("suggest.gphp_fit", "suggest.factorize", "suggest.acq_opt")), flush=True)
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

    # (d) the kriging believer: each pending trial is fantasized at the
    # posterior mean, so each fantasy predicts through matern52_gram
    _, res, kb_launches = drive("(d) kriging believer",
                                BOConfig(**{**paper, "pending_strategy": "kb"}), 16, 4,
                                "acq_score")
    if not math.isfinite(res.best_objective):
        fail("(d) kriging believer: best objective not finite")
    phase_done("5 multi-metric, cost-aware and kriging-believer paths", t_phase)

    # 8. the §5 paths: early stopping, the multi-job service, multi-fidelity
    # and the quality gate, at the same engine configuration
    t_phase = time.perf_counter()
    s5_launches = section5_phase(
        np, torch, K, telemetry, space, objective, paper, drive, run_job, card)
    phase_done("8 §5 paths", t_phase)

    # 9. the rest of the engine: large n, per-head chains, the wire
    t_phase = time.perf_counter()
    large_launches = large_n_phase(
        np, torch, K, telemetry, space, objective, metric_objective, CONSTRAINED,
        paper, card, checked_buckets, big_chain)
    phase_done("9 large n, per-head chains and the wire", t_phase)

    # 6. the LM serving path
    t_phase = time.perf_counter()
    serve_launches, decode_launches = serve_phase(torch, np, K, check, peaks, dev)
    phase_done("6 serve path", t_phase)

    # 7. the falcon-mamba-7b serving path
    t_phase = time.perf_counter()
    mamba_launches = mamba_phase(torch, K, check, dev)
    phase_done("7 mamba path", t_phase)

    # 12. the Mamba-2 scan's pair, and one mixer trained through it
    t_phase = time.perf_counter()
    hybrid_launches = ssd_phase(torch, K, telemetry, check, dev)
    phase_done("12 Mamba-2 scan", t_phase)

    # 10. AMT tunes real training: granite-moe-1b-a400m served, trained,
    # restarted, and tuned by a BO job of training trials
    t_phase = time.perf_counter()
    train_launches, train_numbers = train_phase(np, torch, K, telemetry, card,
                                                checked_buckets, dev)
    phase_done("10 training and the tuning job", t_phase)

    # 11. sharding on the card: granite-moe-1b-a400m served and trained
    # through a (1, 1) mesh, the production-mesh dry-run, and the dry-run's
    # estimate held against the card
    t_phase = time.perf_counter()
    mesh_launches = mesh_phase(torch, K, card, dev, train_numbers)
    phase_done("11 sharding, mesh and dry-run", t_phase)

    path_launches = {"main": main_launches, "multi": multi_launches, "kb": kb_launches,
                     "serve": serve_launches, "decode_check": decode_launches,
                     "mamba": mamba_launches, "train": train_launches["train"],
                     "hybrid": hybrid_launches}
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
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "s5_launches": {path: counts[kname] for path, counts in s5_launches.items()},
            "large_n_launches": {path: counts[kname]
                                 for path, counts in large_launches.items()},
            "train_launches": {path: counts[kname]
                               for path, counts in train_launches.items()},
            "mesh_launches": mesh_launches[kname],
        })
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
