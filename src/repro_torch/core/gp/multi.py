"""Shared-factor multi-output GP posterior (multi-metric decision engine).

Every metric of a tuning job observes the *same* configurations, so M
independent per-metric GPs over a shared X collapse onto **one** Cholesky
factor when the heads share hyperparameters: K̃ depends only on X and the
GPHPs, never on the targets. A multi-output posterior is therefore the
single-output ``GPPosterior`` (factor, mask, cached L⁻¹, GPHP draws —
everything the incremental rank-1 machinery of
``repro_torch.core.gp.incremental`` maintains) plus one extra alpha vector
per metric head:

    factorize once          O(S·n³)  — unchanged, objective path
    alpha_j = K̃⁻¹ y_j       O(S·n²)  per head — one batched cholesky_solve
    predict: shared k*/V    O(S·m·n²) once; each extra head adds one
                            (m×n)·(n,) matvec for its mean

The predictive *variance* is identical across heads (shared amplitude and
factor), which is what the constrained/scalarized acquisition functions in
``repro_torch.core.multimetric.acquisition`` exploit.

Head 0 is always the primary objective and its alpha duplicates
``base.alpha``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.gp.gp import GPPosterior
from repro_torch.core.gp.kernels import gram

__all__ = ["MultiOutputPosterior", "solve_head_alphas", "predict_heads"]


class MultiOutputPosterior(NamedTuple):
    """A ``GPPosterior`` extended with per-metric alpha vectors.

    ``base`` carries the shared factor (and the objective alpha used by the
    single-metric code paths); ``alphas`` holds K̃⁻¹y_j for every head —
    shape (S, M, n) with head 0 equal to ``base.alpha``."""

    base: GPPosterior
    alphas: torch.Tensor  # (S, M, n)

    @property
    def num_heads(self) -> int:
        return self.alphas.shape[1]


def solve_head_alphas(base: GPPosterior, y_heads: torch.Tensor) -> torch.Tensor:
    """alpha_j = K̃⁻¹ y_j for all heads from the shared cached factor:
    ``y_heads`` (M, n_pad) → (S, M, n_pad). O(S·M·n²): one batched
    ``cholesky_solve`` over the S samples with the M heads as right-hand
    sides. Masked rows are zeroed, like ``refresh_alpha``."""
    y = torch.where(base.mask[None, :], y_heads, torch.zeros_like(y_heads))
    chol = base.chol if base.chol.ndim == 3 else base.chol[None]
    rhs = y.T.to(chol.dtype).expand(chol.shape[0], -1, -1)  # (S, n, M)
    return torch.cholesky_solve(rhs, chol, upper=False).transpose(-1, -2)


def predict_heads(
    mp: MultiOutputPosterior, x_star: torch.Tensor, *, backend: str = "torch"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior marginals of every head at ``x_star``: (mu, var) with
    ``mu`` (S, M, m) and ``var`` (S, m) — variance shared across heads
    (common factor + amplitude). The expensive pieces (cross-gram and the
    triangular solve) are computed once and amortized over the M heads."""
    base = mp.base
    if base.chol.ndim != 3:
        base = base._replace(
            chol=base.chol[None],
            alpha=base.alpha[None],
            params=type(base.params)(*(p[None] for p in base.params)),
        )
    k_star = gram(base.x_train, x_star, base.params, backend=backend)  # (S, n, m)
    k_star = k_star * base.mask[:, None].to(k_star.dtype)
    mu = torch.matmul(mp.alphas, k_star)  # (S, M, m)
    v = torch.linalg.solve_triangular(base.chol, k_star, upper=False)
    amp2 = torch.exp(2.0 * base.params.log_amplitude)[:, None]
    var = torch.clamp_min(amp2 - torch.sum(v * v, dim=-2), 1e-12)
    return mu, var
