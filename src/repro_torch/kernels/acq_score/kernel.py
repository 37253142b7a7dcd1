"""Wrappers of the fused anchor-scoring CUDA kernels (``csrc/acq_score.cu``,
``csrc/acq_score_multi.cu``).

A CPU tensor runs the plain version (``plain.py``); a CUDA tensor launches
the kernel on the current stream, or raises. The output is allocated here
with ``torch.empty``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels._launch import check_inputs, raise_on_error, suffix
from repro_torch.kernels.acq_score.plain import acq_score_multi_plain, acq_score_plain

__all__ = ["acq_score_kernel", "acq_score_multi_kernel", "ACQ_MODES", "MULTI_MODES"]

ACQ_MODES = {"ei": 0, "lcb": 1}
MULTI_MODES = {"constrained": 0, "pareto": 1, "rungs": 2, "cost": 3}


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
    with torch.cuda.device(anchors.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in args), float(y_best), float(kappa),
                 out.data_ptr(), S, m, n, d, ACQ_MODES[acq], stream)
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
    lib = _build.library("acq_score_multi")
    dev = anchors.device.index if anchors.device.index is not None else torch.cuda.current_device()
    need = lib.acq_score_multi_smem_bytes(d, M, wr, wc, yr, tc, anchors.element_size())
    limit = lib.acq_score_multi_smem_limit(dev)
    if need > limit:
        raise ValueError(
            f"acq_score_multi needs {need} bytes of shared memory per block for "
            f"M={M} heads, W={wr}×K={wc} weights and d={d}; the card allows {limit}"
        )
    fn = getattr(lib, f"acq_score_multi_{suffix(anchors.dtype)}")
    with torch.cuda.device(anchors.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in args), float(y_best),
                 1.0 if has_feasible else 0.0, out.data_ptr(),
                 S, m, n, d, M, num_con, wr, wc, yr, MULTI_MODES[mode], stream)
    raise_on_error("acq_score_multi", err)
    LAUNCHES["acq_score_multi"] += 1
    return out
