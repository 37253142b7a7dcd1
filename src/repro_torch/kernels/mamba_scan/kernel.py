"""Wrapper of the Mamba-1 selective-scan CUDA kernel.

A CPU tensor runs the plain version (``plain.py``); a CUDA tensor launches
the kernel from ``csrc/mamba_scan.cu`` on the current stream, or raises.
The kernel keeps each channel's states in one thread's registers, streams
u, Δ, b and c through a ring of shared-memory tiles by ``cp.async`` and
computes exp(Δ·a) as 2^(Δ·a·log₂e) on the special-function units
(``ex2.approx``, within 2 ulp). The wrapper checks the inputs, allocates
the outputs and tells the kernel whether u and Δ can be copied 16 bytes at
a time.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels._launch import check_inputs, raise_on_error
from repro_torch.kernels.mamba_scan.plain import mamba_scan_plain

__all__ = ["mamba_scan_kernel", "vector_copies", "MAX_STATE"]

MAX_STATE = 16  # a channel's states: the kernel's registers, zero-padded past d_state


def vector_copies(u: torch.Tensor, dt: torch.Tensor) -> bool:
    """Whether the kernel may copy u and Δ 16 bytes at a time: each row of
    d_inner channels a whole number of 16-byte vectors, and both tensors
    16-byte aligned. Otherwise it copies 4 bytes at a time."""
    return u.shape[-1] % 4 == 0 and u.data_ptr() % 16 == 0 and dt.data_ptr() % 16 == 0


def mamba_scan_kernel(u, dt, a, b, c) -> Tuple[torch.Tensor, torch.Tensor]:
    """u, dt (B, S, di); a (di, ds); b, c (B, S, ds); float32 →
    (y (B, S, di), h_last (B, di, ds))."""
    bsz, s, di = u.shape
    ds = a.shape[-1]
    shapes = ((bsz, s, di), (bsz, s, di), (di, ds), (bsz, s, ds), (bsz, s, ds))
    if check_inputs("mamba_scan", (u, dt, a, b, c), shapes, (torch.float32,)) == "cpu":
        return mamba_scan_plain(u, dt, a, b, c)
    if not 1 <= ds <= MAX_STATE:
        raise ValueError(f"mamba_scan: d_state {ds} must be in 1..{MAX_STATE}")
    y = torch.empty_like(u)
    h_last = torch.zeros((bsz, di, ds), dtype=u.dtype, device=u.device)
    if u.numel() == 0:
        return y, h_last
    fn = _build.library("mamba_scan").mamba_scan_f32
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(u.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 y.data_ptr(), h_last.data_ptr(), bsz, s, di, ds, int(vector_copies(u, dt)),
                 stream)
    raise_on_error("mamba_scan", err)
    LAUNCHES["mamba_scan"] += 1
    return y, h_last
