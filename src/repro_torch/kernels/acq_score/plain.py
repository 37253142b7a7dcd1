"""Plain PyTorch version of the fused anchor-scoring kernel.

The same function as ``csrc/acq_score.cu`` on the same packed inputs:
anchors (m, d), train rows (n, d), L⁻¹ (S, n, n), α (S, n), mask (n,),
per-sample inv_ell / a / b / on (S, d) and amp² (S,). Returns (S, m).
Built from the engine's own torch arithmetic (the packed Matérn-5/2 gram
and ``acquisition``'s EI / LCB).
"""

from __future__ import annotations

import torch

from repro_torch.core import acquisition as A
from repro_torch.kernels.matern52.plain import matern52_gram_plain

__all__ = ["acq_score_plain"]


def acq_score_plain(
    anchors, x_train, linv, alpha, mask, inv_ell, a, b, on, amp2,
    y_best: float, kappa: float, acq: str,
) -> torch.Tensor:
    k_star = matern52_gram_plain(anchors, x_train, inv_ell, a, b, on, amp2) * mask
    mu = torch.matmul(k_star, alpha[..., None])[..., 0]  # (S, m)
    v = torch.matmul(linv, k_star.transpose(-1, -2))  # (S, n, m)
    var = torch.clamp_min(amp2[:, None] - torch.sum(v * v, dim=-2), 1e-12)
    if acq == "ei":
        return A.expected_improvement(mu, var, y_best)
    return A.lcb(mu, var, kappa)
