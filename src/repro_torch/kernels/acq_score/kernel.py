"""Wrapper of the fused anchor-scoring CUDA kernel (``csrc/acq_score.cu``).

A CPU tensor runs the plain version (``plain.py``); a CUDA tensor launches
the kernel on the current stream, or raises. The output is allocated here
with ``torch.empty``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels._launch import check_inputs, raise_on_error, suffix
from repro_torch.kernels.acq_score.plain import acq_score_plain

__all__ = ["acq_score_kernel", "ACQ_MODES"]

ACQ_MODES = {"ei": 0, "lcb": 1}


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
