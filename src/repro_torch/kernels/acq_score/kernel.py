"""Wrappers of the fused anchor-scoring CUDA kernels (``csrc/acq_score.cu``,
``csrc/acq_score_multi.cu``).

A CPU tensor runs the plain version (``plain.py``); a CUDA tensor launches
the kernel on the current stream, or raises. The output, and a paired
walk's workspace, are allocated here with ``torch.empty``.

``walk_plan`` chooses the launch's tiling (``csrc/acq_walk.cuh``): anchors
a block, rows of L⁻¹ a row block and so the number of row-block pairs, and
the shared memory a block needs (``smem_bytes`` mirrors the header's
``Layout``; ``chip_smoke.py`` holds the two equal on the card).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels._launch import check_inputs, raise_on_error, suffix
from repro_torch.kernels.acq_score.plain import acq_score_multi_plain, acq_score_plain

__all__ = [
    "acq_score_kernel", "acq_score_multi_kernel", "ACQ_MODES", "MULTI_MODES",
    "MAX_HEADS", "WalkPlan", "kstar_smem_bytes", "pairs_of", "smem_bytes", "walk_plan",
]

ACQ_MODES = {"ei": 0, "lcb": 1}
MULTI_MODES = {"constrained": 0, "pareto": 1, "rungs": 2, "cost": 3}

# csrc/acq_walk.cuh: train rows a chunk, ring stages, ring row stride, the
# α tile's rows, train rows a K* block; the row-block heights the walk
# takes, tallest first.
BK = 16
STAGES = 3
LDL = BK + 4
MAX_HEADS = 16
KROWS = 64
ROW_BLOCKS = (128, 64, 32, 16)


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def _round_up(x: int, k: int) -> int:
    return -(-x // k) * k


def pairs_of(n: int, bm: int) -> int:
    """Walk blocks along the rows of L⁻¹: one for α and the last row block,
    one for each further pair of row blocks."""
    return 1 + -(-n // bm) // 2


def is_single(n: int, bm: int) -> bool:
    """One row block of at most 64 rows: the block warps, computes K* and
    holds it itself (α on a spare warp)."""
    return -(-n // bm) == 1 and bm <= 64


def smem_bytes(ta: int, bm: int, n: int, dp: int, elem: int) -> int:
    """Dynamic shared memory of one walk block (the header's ``Layout``).
    Single: the warped anchors and rows and the mask (reused by the ‖v‖²
    partials and means at the end), K* of every row, then the ring's
    stages of α rows and the row block. Pairs: the ring's stages of two row
    blocks and the chunk's K*ᵀ tile, then the partials and means."""
    single = is_single(n, bm)
    npad = _round_up(n, BK)
    ends = _round4(bm // 16 * ta) + _round4(MAX_HEADS * ta)
    lo_rows = MAX_HEADS if single else bm
    ring = _round4(STAGES * ((lo_rows + bm) * LDL + (0 if single else BK * (ta + 4))))
    if not single:  # float: the α rows' sums in double
        return (ring + ends + (2 * MAX_HEADS * ta if elem == 4 else 0)) * elem
    held = _round4(ta * (dp | 1)) + _round4(npad * dp) + _round4(npad)
    return (max(held, ends) + _round4(npad * (ta + 4)) + ring) * elem


def kstar_smem_bytes(ta: int, dp: int, elem: int) -> int:
    """Shared memory of one K* block of a paired walk: its warped anchors
    and train rows."""
    return (_round4(ta * (dp | 1)) + KROWS * dp) * elem


class WalkPlan(NamedTuple):
    ta: int  # anchors a block
    bm: int  # rows of L⁻¹ a row block
    pairs: int  # walk blocks along the rows of one sample and anchor tile
    single: bool  # one row block (n ≤ bm ≤ 64): one launch, K* in the block
    smem: int  # bytes of dynamic shared memory a walk block (8 warps)
    blocks: int  # the walk's grid

    def workspace(self, S: int, m: int, n: int, dp: int, M: int) -> int:
        """Elements of the workspace (the header's ``Workspace``): none for
        a single walk; else K*ᵀ, the warped anchors and rows and, with more
        than one block along the rows, their ‖v‖² partials and the means."""
        if self.single:
            return 0
        npad, mpad = _round_up(n, BK), _round_up(m, self.ta)
        size = _round4(S * npad * mpad) + _round4(S * mpad * dp) + _round4(S * npad * dp)
        if self.pairs > 1:
            size += (self.pairs + M) * S * m
        return size


def walk_plan(S: int, m: int, n: int, dp: int, elem: int, sms: int,
              smem_limit: int, name: str = "acq_score") -> WalkPlan:
    """The tiling of a launch over S samples, m anchors, n train rows and dp
    features of ``elem`` bytes, on a card with ``sms`` SMs that lets a block
    use ``smem_limit`` bytes of shared memory.

    Up to 64 rows (every bucket of the main path) a single walk: the
    shortest row block that covers n, 32 anchors a block so that the grid
    runs in one wave, three blocks an SM, one launch. Above, a K* pass and a
    paired walk of 64 anchors a block (each L⁻¹ element loaded serves 64):
    the tallest row block whose grid fills the card, or the shortest, which
    comes closest. 8 anchors a block for the re-rank's m ≤ 16. Raises
    ValueError, naming the limit, when nothing fits."""
    single = [bm for bm in sorted(ROW_BLOCKS) if is_single(n, bm)
              and smem_bytes(8 if m <= 16 else 32, bm, n, dp, elem) <= smem_limit]
    if single:
        ta = 8 if m <= 16 else 32
        bm = single[0]
    else:
        ta = 8 if m <= 16 else 64
        if kstar_smem_bytes(ta, dp, elem) > smem_limit:
            raise ValueError(
                f"{name} needs {kstar_smem_bytes(ta, dp, elem)} bytes of shared memory per "
                f"K* block for d={dp} features ({elem}-byte elements); the card allows "
                f"{smem_limit}"
            )
        fits = [b for b in ROW_BLOCKS
                if not is_single(n, b) and smem_bytes(ta, b, n, dp, elem) <= smem_limit]
        if not fits:
            raise ValueError(
                f"{name} needs {smem_bytes(ta, ROW_BLOCKS[-1], n, dp, elem)} bytes of shared "
                f"memory per block for n={n} rows ({elem}-byte elements); the card allows "
                f"{smem_limit}"
            )
        tiles = -(-m // ta)
        bm = next((b for b in fits if tiles * S * pairs_of(n, b) >= sms), fits[-1])
    P = pairs_of(n, bm)
    return WalkPlan(ta, bm, P, bool(single), smem_bytes(ta, bm, n, dp, elem),
                    -(-m // ta) * S * P)


@functools.lru_cache(maxsize=None)
def _card(lib_name: str, dev: int) -> tuple:
    """(SM count, shared-memory opt-in limit) of card ``dev``."""
    lib = _build.library(lib_name)
    limit = getattr(lib, f"{lib_name}_smem_limit")(dev)
    return torch.cuda.get_device_properties(dev).multi_processor_count, limit


def _plan_launch(lib_name: str, tensor: torch.Tensor, S: int, m: int, n: int,
                 dp: int, M: int, *copied) -> tuple:
    """The plan and workspace of a launch on ``tensor``'s card. The
    ``copied`` tensors (L⁻¹, α) arrive by 16-byte cp.async: they must start
    on a 16-byte boundary."""
    if any(t.data_ptr() % 16 for t in copied):
        raise ValueError(f"{lib_name}: L⁻¹ and α must start on a 16-byte boundary")
    dev = tensor.device.index if tensor.device.index is not None else torch.cuda.current_device()
    sms, limit = _card(lib_name, dev)
    if n % 8 or dp % 8:
        raise ValueError(f"{lib_name}: train rows ({n}) and features ({dp}) must be padded "
                         "to multiples of 8 (ops.pack_inputs pads them)")
    plan = walk_plan(S, m, n, dp, tensor.element_size(), sms, limit, lib_name)
    size = plan.workspace(S, m, n, dp, M)
    return plan, torch.empty(size, dtype=tensor.dtype, device=tensor.device)


def acq_score_kernel(
    anchors, x_train, linv, alpha, mask, inv_ell, a, b, on, amp2,
    y_best: float, kappa: float, acq: str = "ei",
) -> torch.Tensor:
    """Per-sample acquisition at every anchor: (S, m). Larger is better."""
    if acq not in ACQ_MODES:
        raise ValueError(f"unsupported acquisition {acq!r}")
    m, d = anchors.shape
    S, n, _ = linv.shape
    args = (anchors, x_train, linv, alpha, mask, inv_ell, a, b, on, amp2)
    shapes = ((m, d), (n, d), (S, n, n), (S, n), (n,),
              (S, d), (S, d), (S, d), (S, d), (S,))
    if check_inputs("acq_score", args, shapes) == "cpu":
        return acq_score_plain(*args, float(y_best), float(kappa), acq)
    out = torch.empty((S, m), dtype=anchors.dtype, device=anchors.device)
    if S * m == 0:
        return out
    fn = getattr(_build.library("acq_score"), f"acq_score_{suffix(anchors.dtype)}")
    plan, ws = _plan_launch("acq_score", anchors, S, m, n, d, 1, linv, alpha)
    with torch.cuda.device(anchors.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in args), float(y_best), float(kappa),
                 out.data_ptr(), ws.data_ptr() if ws.numel() else None, S, m, n, d,
                 ACQ_MODES[acq], plan.ta,
                 plan.bm, plan.smem, stream)
    raise_on_error("acq_score", err)
    LAUNCHES["acq_score"] += 1
    return out


def acq_score_multi_kernel(
    anchors, x_train, linv, alphas, mask, inv_ell, a, b, on, amp2,
    tcon, weights, y_best_w, y_best: float, has_feasible: bool,
    mode: str, num_con: int,
) -> torch.Tensor:
    """Per-sample multi-head acquisition at every anchor: (S, m). Larger is
    better. ``mode``: "constrained" | "pareto" | "rungs" | "cost" (see
    ``plain.acq_score_multi_plain`` for the head inputs of each)."""
    if mode not in MULTI_MODES:
        raise ValueError(f"unsupported mode {mode!r}")
    m, d = anchors.shape
    S, M, n = alphas.shape
    wr, wc = weights.shape
    yr = y_best_w.shape[0]
    tc = tcon.shape[0]
    fits = 0 <= num_con <= tc and {
        "constrained": 1 + num_con <= M,
        "pareto": yr == wr and wc + num_con <= M,
        "rungs": (wr, wc, yr) == (1, M, M) and num_con == 0,
        "cost": (wr, wc) == (1, 1) and M >= 2 and num_con == 0,
    }[mode]
    if not fits:
        raise ValueError(
            f"acq_score_multi {mode}: weights {(wr, wc)}, incumbents ({yr},) and "
            f"{num_con} of {tc} thresholds do not fit {M} heads"
        )
    args = (anchors, x_train, linv, alphas, mask, inv_ell, a, b, on, amp2,
            tcon, weights, y_best_w)
    shapes = ((m, d), (n, d), (S, n, n), (S, M, n), (n,),
              (S, d), (S, d), (S, d), (S, d), (S,), (tc,), (wr, wc), (yr,))
    if check_inputs("acq_score_multi", args, shapes) == "cpu":
        return acq_score_multi_plain(*args, float(y_best), bool(has_feasible),
                                     mode, num_con)
    out = torch.empty((S, m), dtype=anchors.dtype, device=anchors.device)
    if S * m == 0:
        return out
    if M > MAX_HEADS:
        raise ValueError(
            f"acq_score_multi takes at most {MAX_HEADS} heads (one 16-row tile of "
            f"α under L⁻¹), got {M}"
        )
    lib = _build.library("acq_score_multi")
    plan, ws = _plan_launch("acq_score_multi", anchors, S, m, n, d, M, linv, alphas)
    fn = getattr(lib, f"acq_score_multi_{suffix(anchors.dtype)}")
    with torch.cuda.device(anchors.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in args), float(y_best),
                 1.0 if has_feasible else 0.0, out.data_ptr(),
                 ws.data_ptr() if ws.numel() else None,
                 S, m, n, d, M, num_con, wr, wc, MULTI_MODES[mode],
                 plan.ta, plan.bm, plan.smem, stream)
    raise_on_error("acq_score_multi", err)
    LAUNCHES["acq_score_multi"] += 1
    return out
