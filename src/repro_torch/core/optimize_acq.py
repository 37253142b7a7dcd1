"""Acquisition optimization (paper §4.3), single-metric.

"the resulting pseudo-random grid [a Sobol sequence populating the search
space as densely as possible] is used as a set of anchor points to initialize
the local optimization of the EI. This scales linearly in the number of
locations and works well in practice."

Pipeline:
  1. evaluate the integrated acquisition at ``num_anchors`` Sobol points;
  2. mask anchors within ``exclusion_radius`` of pending candidates (the
     paper's "making sure not to select one of the L−1 pending candidates");
  3. take the ``num_refine`` best anchors and run projected-Adam ascent on the
     acquisition (``torch.autograd`` flows through the GP posterior),
     clipping to the unit cube;
  4. return refined candidates ranked by acquisition value.

Backends: ``AcqOptConfig.backend`` selects how stage 1 (and the final
re-ranking) scores anchors. ``"kernel"`` (the default) dispatches EI/LCB to
the fused predict+acquisition kernel (``repro_torch.kernels.acq_score``):
cross-gram, cached-inverse solve and the closed form on the card, each K*
entry computed once. ``"torch"`` is the plain composition
(``gp.predict`` + closed form). Stage 3 always evaluates through the torch
composition — the kernel has no backward pass — so the dense anchor sweep is
fused while the 8-point ascent keeps exact gradients.

Ranking ties (anchors masked to −inf tie often) resolve to the lower index
first, as ``jax.lax.top_k`` and ``jnp.argsort`` do: a stable sort on the
negated values.

``optimize_acquisition_multi`` runs the same pipeline on the multi-head
acquisitions (constrained EI, random-scalarization EI, rung-weighted EI and
EI-per-unit-cost) over the shared-factor posterior: the anchor sweep and the
final re-rank through the fused ``acq_score_multi`` kernel, the refinement
through the torch composition. In the per-head layout (``per_head_gphp``:
one GPHP chain and one factor per head) every head predicts through its own
factor, so the variances differ by head and the shared-variance kernel does
not apply: the anchor sweep and the refinement both go through the torch
composition there, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import acquisition as A
from repro_torch.core import prng
from repro_torch.core.gp.gp import GPPosterior, predict
from repro_torch.core.multimetric.acquisition import constrained_ei, scalarized_ei

__all__ = [
    "AcqOptConfig",
    "MultiMetricHead",
    "optimize_acquisition",
    "optimize_acquisition_multi",
]


class AcqOptConfig(NamedTuple):
    acq: str = "ei"  # "ei" | "lcb" | "ts"
    num_anchors: int = 1024
    num_refine: int = 8  # anchors promoted to gradient refinement
    refine_steps: int = 25
    refine_lr: float = 0.05
    lcb_kappa: float = 2.0
    exclusion_radius: float = 0.02  # L∞ radius (unit cube) around pending pts
    backend: str = "kernel"  # anchor scoring: "kernel" (fused) | "torch"


def _acq_values(
    post: GPPosterior,
    x: torch.Tensor,
    y_best: torch.Tensor,
    cfg: AcqOptConfig,
    key: np.ndarray,
    *,
    differentiable: bool = False,
) -> torch.Tensor:
    """Integrated acquisition at x: (m, d) -> (m,). Larger is better.

    ``differentiable=True`` forces the torch predict+closed-form composition
    (the refinement stage needs autograd); otherwise EI/LCB on the kernel
    backend go through the fused anchor-scoring kernel."""
    if cfg.backend not in ("kernel", "torch"):
        raise ValueError(f"unknown acquisition backend {cfg.backend!r}")
    if cfg.acq in ("ei", "lcb") and cfg.backend == "kernel" and not differentiable:
        from repro_torch.kernels.acq_score.ops import acq_score

        vals = acq_score(post, x, y_best, acq=cfg.acq, kappa=cfg.lcb_kappa)
        return A.integrate_over_samples(vals)
    mu, var = predict(post, x, backend="torch" if differentiable else cfg.backend)
    if cfg.acq == "ei":
        vals = A.expected_improvement(mu, var, y_best)
    elif cfg.acq == "lcb":
        vals = A.lcb(mu, var, cfg.lcb_kappa)
    elif cfg.acq == "ts":
        # Thompson: negative draws so larger is better; the argmax anchor is
        # the Thompson-sample minimizer. The reference's refinement scores
        # one point per call, so each point there draws (S, 1) normals.
        shape = tuple(mu.shape[:-1]) + (1,) if differentiable else None
        vals = -A.thompson_draws(mu, var, key, shape)
    else:
        raise ValueError(f"unknown acquisition {cfg.acq!r}")
    return A.integrate_over_samples(vals)


def _descending(vals: torch.Tensor) -> torch.Tensor:
    """Indices of ``vals`` from largest to smallest, ties lower-index first."""
    return torch.argsort(-vals, stable=True)


def _refine_and_rank(
    masked_acq,
    anchors: torch.Tensor,
    cfg: AcqOptConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stages 2–4 of the pipeline: top-k anchors → projected-Adam ascent on
    the (masked) acquisition → re-rank. ``masked_acq(x, differentiable)``
    scores (m, d) → (m,), larger is better."""
    with torch.no_grad():
        anchor_vals = masked_acq(anchors)  # (num_anchors,)
    top_idx = _descending(anchor_vals)[: cfg.num_refine]
    x0 = anchors[top_idx]  # (num_refine, d)

    # --- projected Adam ascent on the acquisition -------------------------
    # Each point's acquisition depends on that point only, so the gradient
    # of the summed batch is the per-point gradient.
    x = x0.clone()
    m = torch.zeros_like(x0)
    v = torch.zeros_like(x0)
    for step in range(cfg.refine_steps):
        t = float(step)
        xg = x.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(
                masked_acq(xg, differentiable=True).sum(), xg
            )
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mhat = m / (1.0 - 0.9 ** (t + 1.0))
        vhat = v / (1.0 - 0.999 ** (t + 1.0))
        x = torch.clamp(
            x + cfg.refine_lr * mhat / (torch.sqrt(vhat) + 1e-8), 0.0, 1.0
        )

    with torch.no_grad():
        ref_vals = masked_acq(x)
    # A refined point may have walked into the exclusion zone; keep the anchor
    # value as fallback so ranking never returns −inf when anchors were valid.
    top_vals = anchor_vals[top_idx]
    use_ref = ref_vals >= top_vals
    final_x = torch.where(use_ref[:, None], x, x0)
    final_v = torch.where(use_ref, ref_vals, top_vals)
    order = _descending(final_v)
    return final_x[order], final_v[order]


def _pending_masked(score, pending: torch.Tensor, pending_mask: torch.Tensor,
                    cfg: AcqOptConfig):
    """Wrap a scorer with the §4.4 pending-exclusion mask (L∞ radius)."""

    def masked_acq(x: torch.Tensor, differentiable: bool = False) -> torch.Tensor:
        vals = score(x, differentiable)
        if pending.shape[0] > 0:
            # L∞ distance to every pending point
            dists = torch.amax(
                torch.abs(x[:, None, :] - pending[None, :, :]), dim=-1
            )  # (m, p)
            near = torch.any(
                (dists < cfg.exclusion_radius) & pending_mask[None, :], dim=-1
            )
            vals = torch.where(near, torch.full_like(vals, -float("inf")), vals)
        return vals

    return masked_acq


def optimize_acquisition(
    post: GPPosterior,
    anchors: torch.Tensor,  # (num_anchors, d) Sobol points in the unit cube
    y_best: torch.Tensor,  # scalar: best standardized observation
    pending: torch.Tensor,  # (p, d) encoded pending candidates (may be padding)
    pending_mask: torch.Tensor,  # (p,) bool
    key: np.ndarray,
    cfg: AcqOptConfig = AcqOptConfig(),
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (candidates, acq_values): (num_refine, d) refined points sorted
    best-first, with pending-exclusion applied."""
    k_ts, _ = prng.split(key)

    def score(x: torch.Tensor, differentiable: bool) -> torch.Tensor:
        return _acq_values(post, x, y_best, cfg, k_ts,
                           differentiable=differentiable)

    masked_acq = _pending_masked(score, pending, pending_mask, cfg)
    return _refine_and_rank(masked_acq, anchors, cfg)


class MultiMetricHead(NamedTuple):
    """Per-decision state of the multi-metric acquisition: everything beyond
    the shared-factor posterior that the scorer needs. Objectives lead,
    constraints trail (the ``MetricSet`` order).

    ``weights``/``y_best_w`` are the random-scalarization draws of Pareto
    mode (empty, W=0, in constrained mode); ``y_best``/``has_feasible``
    drive constrained EI and are ignored in Pareto mode.

    ``head_posts`` is empty in the default shared-factor layout. With
    ``BOConfig.per_head_gphp`` it carries one ``GPPosterior`` per extra head
    (head 1 first), each fitted under its own GPHP chain; the scorer then
    predicts every head through its own factor (per-head variances) instead
    of the shared-factor alpha block, and ``alphas`` degenerates to the
    objective column.

    The scoring mode is passed beside the head: ``"constrained"`` and
    ``"pareto"`` as above; ``"rungs"`` is the multi-fidelity f(x, r)
    acquisition (heads [objective, rung 0, …, rung R−1], a weighted per-head
    EI); ``"cost"`` is EI-per-unit-cost (``BOConfig.cost_aware``: heads
    [objective, standardized log-cost], EI(head 0) · exp(−η · mean(head 1))
    with η in ``weights[0, 0]``)."""

    alphas: torch.Tensor  # (S, M, n) all-head K̃⁻¹y (head 0 = objective)
    t_std: torch.Tensor  # (C,) standardized signed constraint thresholds
    y_best: float  # best *feasible* standardized objective
    has_feasible: bool  # a feasible incumbent exists
    weights: torch.Tensor  # (W, K) simplex scalarization draws
    y_best_w: torch.Tensor  # (W,) best observed scalarized value per draw
    head_posts: tuple = ()  # per-head GPPosteriors (per_head_gphp only)


def _acq_values_multi(
    post: GPPosterior,
    head: MultiMetricHead,
    x: torch.Tensor,
    cfg: AcqOptConfig,
    mode: str,
    *,
    differentiable: bool = False,
) -> torch.Tensor:
    """Integrated multi-metric acquisition at x: (m, d) → (m,). The fused
    multi-head kernel serves the dense anchor sweep; gradient refinement
    always goes through the torch composition (autograd), and so does every
    score of the per-head layout."""
    from repro_torch.kernels.acq_score.ops import acq_score_multi

    if cfg.backend not in ("kernel", "torch"):
        raise ValueError(f"unknown acquisition backend {cfg.backend!r}")
    if head.head_posts:
        # per-head layout (BOConfig.per_head_gphp): every head predicts
        # through its own factor, so the variances are per head and the
        # fused shared-variance kernel does not apply
        mu0, var0 = predict(post, x, backend="torch")
        mus, vrs = [mu0], [var0]
        for hp in head.head_posts:
            muh, varh = predict(hp, x, backend="torch")
            mus.append(muh)
            vrs.append(varh)
        mu = torch.stack(mus, dim=1)  # (S, M, m)
        var = torch.stack(vrs, dim=1)  # (S, M, m) per-head variances
        if mode == "constrained":
            vals = constrained_ei(
                mu, var, head.y_best, head.t_std, head.has_feasible
            )
        else:
            vals = scalarized_ei(
                mu, var, head.weights, head.y_best_w, head.t_std
            )
        return A.integrate_over_samples(vals)
    backend = "torch" if differentiable else cfg.backend
    vals = acq_score_multi(post, head, x, mode=mode, backend=backend)
    return A.integrate_over_samples(vals)


def optimize_acquisition_multi(
    post: GPPosterior,  # shared-factor posterior (objective head resident)
    head: MultiMetricHead,
    anchors: torch.Tensor,  # (num_anchors, d) Sobol points in the unit cube
    pending: torch.Tensor,  # (p, d) encoded pending candidates (may be padding)
    pending_mask: torch.Tensor,  # (p,) bool
    key: np.ndarray,
    cfg: AcqOptConfig,
    mode: str,  # "constrained" | "pareto" | "rungs" | "cost"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-metric analogue of ``optimize_acquisition``: the same Sobol
    anchors → top-k → projected-Adam pipeline, scored by the multi-head
    acquisition of ``mode`` over the shared-factor posterior."""
    del key  # multi-metric modes are EI-based; no Thompson draws

    def score(x: torch.Tensor, differentiable: bool) -> torch.Tensor:
        return _acq_values_multi(
            post, head, x, cfg, mode, differentiable=differentiable
        )

    masked_acq = _pending_masked(score, pending, pending_mask, cfg)
    return _refine_and_rank(masked_acq, anchors, cfg)
