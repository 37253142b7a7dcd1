"""Plain PyTorch version of the Mamba-1 selective-scan kernel.

The same function as ``csrc/mamba_scan.cu``, written as the JAX package's
oracle (``mamba_scan/ref.py::selective_scan_ref``) writes it: a loop over
time from h = 0,

    h_t = exp(dt_t·a) ⊙ h_{t−1} + (dt_t·u_t)·b_t,    y_t = h_t·c_t,

with the (B, di, ds) state carried in float32. The kernel may fuse the
multiplies and adds (one rounding instead of two) and sums y in another
order, so the two agree to rounding.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["mamba_scan_plain"]


def mamba_scan_plain(u, dt, a, b, c) -> Tuple[torch.Tensor, torch.Tensor]:
    """u, dt (B, S, di); a (di, ds); b, c (B, S, ds) → (y (B, S, di), h at
    the last step (B, di, ds))."""
    bsz, s, di = u.shape
    h = torch.zeros((bsz, di, a.shape[1]), dtype=u.dtype, device=u.device)
    y = torch.empty_like(u)
    for t in range(s):
        a_bar = torch.exp(dt[:, t, :, None] * a[None])
        h = a_bar * h + (dt[:, t] * u[:, t])[:, :, None] * b[:, t, None, :]
        y[:, t] = torch.einsum("bis,bs->bi", h, c[:, t])
    return y, h
