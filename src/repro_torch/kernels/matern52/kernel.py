"""Wrappers of the Matérn-5/2 CUDA kernels: the gram, the cross rows of an
append and the factorize operand.

A CPU tensor runs the plain version (``plain.py``); a CUDA tensor launches
the kernel from ``csrc/matern52.cu`` on the current stream, or raises.
Outputs are allocated here with ``torch.empty``. ``empty_kernel`` launches
the library's empty kernel: the launch floor the others are timed against.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels._launch import check_inputs, raise_on_error, suffix
from repro_torch.kernels.matern52.plain import (
    matern52_cross_plain,
    matern52_gram_plain,
    matern52_operand_plain,
)

__all__ = [
    "matern52_gram_kernel", "matern52_cross_kernel", "matern52_operand_kernel",
    "empty_kernel",
]

_F64 = (torch.float64,)


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


def matern52_cross_kernel(x_new, x_train, table, idx: int, m: int, warp: bool = True):
    """Cross rows of appending x_new (R, d) at rows idx, idx + 1, … of a
    bucket of m rows, x_train (n, d) its current rows (idx ≤ n), under the
    (S, 3d + 2) float64 table of log GPHPs: (S, R, m) float64, entry (s, r,
    j) = k_s(x_new_r, z_j) with z = x_train[:idx] then x_new, 0 from column
    idx + R on. The gram is float32."""
    R, d = x_new.shape
    n = x_train.shape[0]
    S = table.shape[0]
    if not 0 <= idx <= n:
        raise ValueError(f"matern52_cross: append index {idx} outside [0, {n}]")
    args = (x_new, x_train, table)
    shapes = ((R, d), (n, d), (S, 3 * d + 2))
    if check_inputs("matern52_cross", args, shapes, _F64) == "cpu":
        return matern52_cross_plain(x_new, x_train, table, idx, m, warp)
    out = torch.empty((S, R, m), dtype=torch.float64, device=x_new.device)
    if S * R * m == 0:
        return out
    fn = _build.library("matern52").matern52_cross_f64
    with torch.cuda.device(x_new.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in args), out.data_ptr(), S, R, m, d, idx,
                 int(warp), stream)
    raise_on_error("matern52_cross", err)
    LAUNCHES["matern52_cross"] += 1
    return out


def matern52_operand_kernel(x, table, mask, jitter: float, warp: bool = True):
    """The factorize operand of the bucket's rows x (n, d) under the row
    mask (n,) bool and the (S, 3d + 2) float64 table of log GPHPs:
    (S, n, n) float64, k·mm + I·(1 − mm) + I·mm·(exp(2 log σ) + jitter)
    with the float32 gram k."""
    n, d = x.shape
    S = table.shape[0]
    if mask.dtype != torch.bool or tuple(mask.shape) != (n,) or mask.device != x.device:
        raise ValueError(f"matern52_operand: mask must be ({n},) bool on {x.device}")
    args = (x, table)
    if check_inputs("matern52_operand", args, ((n, d), (S, 3 * d + 2)), _F64) == "cpu":
        return matern52_operand_plain(x, table, mask, jitter, warp)
    mask = mask.contiguous()
    out = torch.empty((S, n, n), dtype=torch.float64, device=x.device)
    if S * n == 0:
        return out
    fn = _build.library("matern52").matern52_operand_f64
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), table.data_ptr(), mask.data_ptr(), out.data_ptr(),
                 S, n, d, int(warp), float(jitter), stream)
    raise_on_error("matern52_operand", err)
    LAUNCHES["matern52_operand"] += 1
    return out


def empty_kernel() -> None:
    """Launch the library's empty kernel on the current stream (uncounted:
    no path runs it)."""
    stream = torch.cuda.current_stream().cuda_stream
    raise_on_error("matern52_empty", _build.library("matern52").matern52_empty(stream))
