"""Plain PyTorch versions of the Matérn-5/2 gram and cross-row kernels.

The same functions as ``csrc/matern52.cu``, on the same packed inputs:
x (rows, d); per-set parameters inv_ell, a, b, on (S, d) and amp2 (S,).
Built from the engine's own torch arithmetic (``kumaraswamy_cdf``,
``sqdist``, ``matern52_response``); the kernels sum the squared distance in
another order, which moves the result only by rounding.
"""

from __future__ import annotations

import torch

from repro_torch.core.gp.kernels import matern52_response, sqdist
from repro_torch.core.gp.warping import kumaraswamy_cdf

__all__ = ["matern52_gram_plain", "matern52_cross_plain", "warp_scale"]


def warp_scale(x, a, b, on, inv_ell) -> torch.Tensor:
    """Packed warp: x (r, d) → (S, r, d), the Kumaraswamy CDF where ``on``
    is 1 (identity where it is 0), times 1/ℓ."""
    p = [t[:, None, :] for t in (a, b, on, inv_ell)]
    w = kumaraswamy_cdf(x[None], p[0], p[1])
    return torch.where(p[2] > 0, w, x[None]) * p[3]


def matern52_gram_plain(x1, x2, inv_ell, a, b, on, amp2) -> torch.Tensor:
    """(n, d) × (m, d) → (S, n, m)."""
    s1 = warp_scale(x1, a, b, on, inv_ell)
    s2 = warp_scale(x2, a, b, on, inv_ell)
    return matern52_response(sqdist(s1, s2), amp2[:, None, None])


def matern52_cross_plain(x_new, x_train, inv_ell, a, b, on, amp2) -> torch.Tensor:
    """(d,) × (n, d) → (S, n)."""
    return matern52_gram_plain(x_new[None], x_train, inv_ell, a, b, on, amp2)[:, 0, :]
