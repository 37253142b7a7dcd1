"""Plain PyTorch versions of the fused anchor-scoring kernels.

The same functions as ``csrc/acq_score.cu`` and ``csrc/acq_score_multi.cu``
on the same packed inputs: anchors (m, d), train rows (n, d), L⁻¹ (S, n, n),
α (S, n) — or the head block α (S, M, n) —, mask (n,), per-sample
inv_ell / a / b / on (S, d) and amp² (S,). Return (S, m). Built from the
engine's own torch arithmetic (the packed Matérn-5/2 gram, ``acquisition``'s
EI / LCB, ``multimetric``'s constrained / scalarized EI and
``per_resource``'s rung-weighted EI).
"""

from __future__ import annotations

import torch

from repro_torch.core import acquisition as A
from repro_torch.core.gp.per_resource import rung_weighted_ei
from repro_torch.core.multimetric.acquisition import constrained_ei, scalarized_ei
from repro_torch.kernels.matern52.plain import matern52_gram_plain

__all__ = ["acq_score_plain", "acq_score_multi_plain", "multi_closed_form"]


def _moments(anchors, x_train, linv, alpha, mask, inv_ell, a, b, on, amp2):
    """μ = K*·α (per head when α carries one) and the shared σ²."""
    k_star = matern52_gram_plain(anchors, x_train, inv_ell, a, b, on, amp2) * mask
    mu = torch.matmul(alpha, k_star.transpose(-1, -2))  # (S, [M,] m)
    v = torch.matmul(linv, k_star.transpose(-1, -2))  # (S, n, m)
    var = torch.clamp_min(amp2[:, None] - torch.sum(v * v, dim=-2), 1e-12)
    return mu, var


def acq_score_plain(
    anchors, x_train, linv, alpha, mask, inv_ell, a, b, on, amp2,
    y_best: float, kappa: float, acq: str,
) -> torch.Tensor:
    mu, var = _moments(anchors, x_train, linv, alpha[:, None, :], mask,
                       inv_ell, a, b, on, amp2)
    if acq == "ei":
        return A.expected_improvement(mu[:, 0], var, y_best)
    return A.lcb(mu[:, 0], var, kappa)


def multi_closed_form(
    mu, var, mode: str, t_std, y_best, has_feasible, weights, y_best_w,
) -> torch.Tensor:
    """The multi-head acquisition of ``mode`` from per-head means ``mu``
    (S, M, m) and the shared variance ``var`` (S, m): (S, m)."""
    if mode == "constrained":
        return constrained_ei(mu, var, y_best, t_std, has_feasible)
    if mode == "pareto":
        return scalarized_ei(mu, var, weights, y_best_w, t_std)
    if mode == "rungs":
        return rung_weighted_ei(mu, var, y_best_w, weights[0])
    # cost: EI on head 0 discounted by exp(−η · mean of the log-cost head)
    return A.expected_improvement(mu[:, 0, :], var, y_best) * torch.exp(
        -weights[0, 0] * mu[:, 1, :]
    )


def acq_score_multi_plain(
    anchors, x_train, linv, alphas, mask, inv_ell, a, b, on, amp2,
    tcon, weights, y_best_w, y_best: float, has_feasible: bool,
    mode: str, num_con: int,
) -> torch.Tensor:
    """Multi-head scores: ``tcon`` (max(C, 1),) thresholds of which the
    first ``num_con`` are live; ``weights`` (W, K) scalarization draws
    (pareto), (1, M) rung weights (rungs) or [[η]] (cost); ``y_best_w`` the
    matching incumbents (W,) / (M,) / unused."""
    mu, var = _moments(anchors, x_train, linv, alphas, mask, inv_ell, a, b, on, amp2)
    return multi_closed_form(mu, var, mode, tcon[:num_con], y_best, has_feasible,
                             weights, y_best_w)
