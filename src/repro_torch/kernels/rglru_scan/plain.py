"""Plain PyTorch version of the RG-LRU scan kernel.

The same function as ``csrc/rglru_scan.cu``, written as the JAX package's
oracle (``rglru_scan/ref.py``) writes it: a loop over time,
h_t = a_t·h_{t−1} + g_t from h = 0. The kernel may fuse the multiply and the
add (one rounding instead of two), so the two agree to rounding.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["rglru_scan_plain"]


def rglru_scan_plain(a: torch.Tensor, g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, g (B, S, di) → (h (B, S, di), h at the last step (B, di))."""
    b, s, di = a.shape
    h = torch.empty_like(a)
    hc = torch.zeros((b, di), dtype=a.dtype, device=a.device)
    for t in range(s):
        hc = a[:, t] * hc + g[:, t]
        h[:, t] = hc
    return h, hc
