"""Wrapper of the RG-LRU scan CUDA kernel.

A CPU tensor runs the plain version (``plain.py``); a CUDA tensor launches
the kernel from ``csrc/rglru_scan.cu`` on the current stream, or raises.
Outputs are allocated here with ``torch.empty``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels._launch import check_inputs, raise_on_error
from repro_torch.kernels.rglru_scan.plain import rglru_scan_plain

__all__ = ["rglru_scan_kernel"]


def rglru_scan_kernel(a: torch.Tensor, g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, g (B, S, di) float32 → (h (B, S, di), h_last (B, di))."""
    b, s, di = a.shape
    if check_inputs("rglru_scan", (a, g), ((b, s, di), (b, s, di)),
                    (torch.float32,)) == "cpu":
        return rglru_scan_plain(a, g)
    h = torch.empty_like(a)
    h_last = torch.zeros((b, di), dtype=a.dtype, device=a.device)
    if b * di == 0:
        return h, h_last
    fn = _build.library("rglru_scan").rglru_scan_f32
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), g.data_ptr(), h.data_ptr(), h_last.data_ptr(),
                 b, s, di, stream)
    raise_on_error("rglru_scan", err)
    LAUNCHES["rglru_scan"] += 1
    return h, h_last
