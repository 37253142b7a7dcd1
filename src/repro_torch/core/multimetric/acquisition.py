"""Multi-metric acquisition functions (minimization convention).

All heads of a multi-output posterior share one Cholesky factor and one
amplitude (``repro_torch.core.gp.multi``), so the per-anchor predictive
variance is common across metrics and only the means differ. Every function
here therefore takes per-head means ``mu`` of shape (S, M, m) — S GPHP
samples, M metric heads (objectives first, constraints after, the
``MetricSet`` ordering contract) — and one shared variance ``var`` of shape
(S, m); the per-head layout (``BOConfig.per_head_gphp``, one factor per
head) passes per-head variances of shape (S, M, m) instead.

* **Constrained EI** (Gardner et al. 2014): EI of the objective head times
  the product of per-constraint feasibility probabilities
  Φ((t_c − μ_c)/σ). With no feasible incumbent yet, the EI factor is
  dropped and the score is pure feasibility search.
* **Random-scalarization EI** (ParEGO-flavoured): for weight draws w on the
  simplex, the scalarization Σ_j w_j y_j of independent heads is Gaussian
  with mean Σ w_j μ_j and variance (Σ w_j²)·σ²; EI against the best
  observed scalarized value, averaged over draws (and multiplied by the
  feasibility product when constraints are declared).

Everything is closed-form torch in the inputs' dtype, so autograd flows
through for the gradient-refinement stage; the fused kernel analogue lives
in ``repro_torch.kernels.acq_score`` (``acq_score_multi``); it serves the
shared layout only.
"""

from __future__ import annotations

import torch

from repro_torch.core.acquisition import expected_improvement

__all__ = ["feasibility_weight", "constrained_ei", "scalarized_ei"]

_SQRT2 = 1.4142135623730951


def _norm_cdf(z: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(z / _SQRT2))


def feasibility_weight(
    mu_con: torch.Tensor,  # (S, C, m) constraint-head means (standardized)
    var: torch.Tensor,  # (S, m) shared — or (S, C, m) per-head — variance
    t_std: torch.Tensor,  # (C,) standardized signed thresholds (feasible ⇔ ≤ t)
) -> torch.Tensor:
    """Π_c P(y_c(x) ≤ t_c) per (sample, anchor): (S, m), each factor and the
    product in [0, 1]. C = 0 returns ones (no constraints ⇒ no discount).

    ``var`` is the shared (S, m) variance in the default one-factor layout;
    the per-head layout (``BOConfig.per_head_gphp``) passes the (S, C, m)
    per-constraint variances instead."""
    if mu_con.shape[1] == 0:
        shape = var.shape if var.ndim == 2 else (var.shape[0], var.shape[-1])
        return torch.ones(shape, dtype=var.dtype, device=var.device)
    if var.ndim == 3:
        sigma = torch.sqrt(torch.clamp_min(var, 1e-16))  # (S, C, m)
    else:
        sigma = torch.sqrt(torch.clamp_min(var, 1e-16))[:, None, :]  # (S, 1, m)
    z = (t_std[None, :, None] - mu_con) / sigma  # (S, C, m)
    return torch.prod(_norm_cdf(z), dim=1)


def constrained_ei(
    mu: torch.Tensor,  # (S, M, m) all-head means; head 0 = objective
    var: torch.Tensor,  # (S, m) shared — or (S, M, m) per-head — variance
    y_best,  # () best *feasible* standardized objective
    t_std: torch.Tensor,  # (C,) standardized signed constraint thresholds
    has_feasible,  # () bool: does a feasible incumbent exist?
) -> torch.Tensor:
    """Constrained EI per (sample, anchor): (S, m). With no feasible
    incumbent the EI factor degenerates to 1 (pure feasibility search)."""
    num_con = t_std.shape[0]
    var_obj = var[:, 0, :] if var.ndim == 3 else var
    var_con = var[:, var.shape[1] - num_con :, :] if var.ndim == 3 else var
    ei = expected_improvement(mu[:, 0, :], var_obj, y_best)
    feas = feasibility_weight(
        mu[:, mu.shape[1] - num_con :, :], var_con, t_std
    )
    return ei * feas if bool(has_feasible) else feas


def scalarized_ei(
    mu: torch.Tensor,  # (S, M, m) all-head means; first K heads = objectives
    var: torch.Tensor,  # (S, m) shared — or (S, M, m) per-head — variance
    weights: torch.Tensor,  # (W, K) simplex weight draws
    y_best_w: torch.Tensor,  # (W,) best observed scalarized value per draw
    t_std: torch.Tensor,  # (C,) standardized constraint thresholds (may be empty)
) -> torch.Tensor:
    """Random-scalarization EI averaged over the W weight draws: (S, m).
    Constraints (heads K..M−1) multiply in as a feasibility product."""
    num_obj = weights.shape[1]
    num_con = t_std.shape[0]
    # scalarized means (S, W, m) = Σ_j w_j μ_j
    mu_s = torch.einsum("wk,skm->swm", weights, mu[:, :num_obj, :])
    if var.ndim == 3:
        # independent heads, per-head variances ⇒ Var[Σ w_j y_j] = Σ w_j² σ_j²
        var_s = torch.einsum(
            "wk,skm->swm", weights * weights, var[:, :num_obj, :]
        )
        var_con = var[:, var.shape[1] - num_con :, :]
    else:
        # shared variance ⇒ Var[Σ w_j y_j] = (Σ w_j²) σ²
        wn2 = torch.sum(weights * weights, dim=1)  # (W,)
        var_s = wn2[None, :, None] * var[:, None, :]  # (S, W, m)
        var_con = var
    ei = expected_improvement(mu_s, var_s, y_best_w[None, :, None])
    out = torch.mean(ei, dim=1)  # (S, m)
    if num_con:
        out = out * feasibility_weight(
            mu[:, mu.shape[1] - num_con :, :], var_con, t_std
        )
    return out
