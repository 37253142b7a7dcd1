"""Wrappers of the Matérn-5/2 gram and cross-row CUDA kernels.

A CPU tensor runs the plain version (``plain.py``); a CUDA tensor launches
the kernel from ``csrc/matern52.cu`` on the current stream, or raises.
Outputs are allocated here with ``torch.empty``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels._launch import check_inputs, raise_on_error, suffix
from repro_torch.kernels.matern52.plain import (
    matern52_cross_plain,
    matern52_gram_plain,
)

__all__ = ["matern52_gram_kernel", "matern52_cross_kernel"]


def matern52_gram_kernel(x1, x2, inv_ell, a, b, on, amp2) -> torch.Tensor:
    """K[s, i, j] = k_s(x1_i, x2_j): (n, d) × (m, d) → (S, n, m)."""
    n, d = x1.shape
    m = x2.shape[0]
    S = amp2.shape[0]
    args = (x1, x2, inv_ell, a, b, on, amp2)
    shapes = ((n, d), (m, d), (S, d), (S, d), (S, d), (S, d), (S,))
    if check_inputs("matern52_gram", args, shapes) == "cpu":
        return matern52_gram_plain(*args)
    out = torch.empty((S, n, m), dtype=x1.dtype, device=x1.device)
    if S * n * m == 0:
        return out
    fn = getattr(_build.library("matern52"), f"matern52_gram_{suffix(x1.dtype)}")
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in args), out.data_ptr(), S, n, m, d, stream)
    raise_on_error("matern52_gram", err)
    LAUNCHES["matern52_gram"] += 1
    return out


def matern52_cross_kernel(x_new, x_train, inv_ell, a, b, on, amp2) -> torch.Tensor:
    """One row per parameter set: (d,) × (n, d) → (S, n)."""
    n, d = x_train.shape
    S = amp2.shape[0]
    args = (x_new, x_train, inv_ell, a, b, on, amp2)
    shapes = ((d,), (n, d), (S, d), (S, d), (S, d), (S, d), (S,))
    if check_inputs("matern52_cross", args, shapes) == "cpu":
        return matern52_cross_plain(*args)
    out = torch.empty((S, n), dtype=x_train.dtype, device=x_train.device)
    if S * n == 0:
        return out
    fn = getattr(_build.library("matern52"), f"matern52_cross_{suffix(x_train.dtype)}")
    with torch.cuda.device(x_train.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in args), out.data_ptr(), S, n, d, stream)
    raise_on_error("matern52_cross", err)
    LAUNCHES["matern52_cross"] += 1
    return out
