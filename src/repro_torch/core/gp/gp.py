"""GP regression core: posterior, marginal likelihood, prediction (paper §4.2).

Model:  f ~ GP(0, K_θ),   y | f(x) ~ N(f(x), σ₀²)

Observations are standardized (zero mean / unit std) by the caller, so the
zero-mean GP holds without loss of generality (paper §4.2).

Shape-bucketing: the engine pads (X, y) to power-of-two buckets and passes a
boolean ``mask`` over rows. Masked rows are made *exactly* inert by pinning
their kernel rows/cols to the identity and their targets to zero:

    K̃ij = Kij·mi·mj + δij·(1 − mi·mj)   ⇒   log|K̃| and yᵀK̃⁻¹y are unaffected.

MCMC support: parameters with a leading (S,) sample axis broadcast through
every function (the batch dimension stands in for ``jax.vmap``) —
``fit_posterior_batch`` factorizes all S draws at once and ``predict`` then
returns per-sample means/variances.

A failed Cholesky (not positive definite) yields NaN factors, as XLA's does,
rather than raising: the slice sampler reads the NaN log-density as "outside
the slice".
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.gp.kernels import gram
from repro_torch.core.gp.params import GPHyperBounds, GPHyperParams

__all__ = [
    "GPPosterior",
    "log_marginal_likelihood",
    "log_posterior_density",
    "fit_gp",
    "fit_posterior_batch",
    "predict",
    "cholesky",
    "cho_solve",
]

_JITTER = 1e-8
_LOG2PI = 1.8378770664093453


class GPPosterior(NamedTuple):
    """Cholesky-factorized GP posterior. Fields may carry a leading MCMC
    sample axis (S, ...) — produced by ``fit_posterior_batch``.

    ``chol_inv`` (optional) caches L⁻¹ for the fused anchor-scoring kernel
    (``repro_torch.kernels.acq_score``), whose solve is the product L⁻¹K*ᵀ.
    It is built once per refit (``with_inverse=True``), updated in O(n²) by
    the rank-1 border append and identity-padded on bucket growth."""

    x_train: torch.Tensor  # (n, d) encoded (unwarped) inputs
    mask: torch.Tensor  # (n,) bool — valid rows
    chol: torch.Tensor  # (..., n, n) lower Cholesky of K̃ + σ²I
    alpha: torch.Tensor  # (..., n)  K̃⁻¹ y
    params: GPHyperParams  # (...,) GPHPs
    chol_inv: Optional[torch.Tensor] = None  # (..., n, n) cached L⁻¹

    @property
    def num_samples(self) -> int:
        return self.chol.shape[0] if self.chol.ndim == 3 else 1


def cholesky(kmat: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN where the matrix is not positive definite
    (XLA's convention), never an exception."""
    chol, info = torch.linalg.cholesky_ex(kmat)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(chol, float("nan")), chol)


def cho_solve(chol: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K̃⁻¹y from the lower factor: two triangular solves. y: (..., n)."""
    z = torch.linalg.solve_triangular(chol, y[..., None], upper=False)
    return torch.linalg.solve_triangular(
        chol.transpose(-1, -2), z, upper=True
    )[..., 0]


def masked_operand(
    k: torch.Tensor, mask: torch.Tensor, noise: torch.Tensor
) -> torch.Tensor:
    """K̃ = k·mm + I·(1 − mm) + I·mm·noise of a gram k (..., n, n): masked
    rows/cols become identity, the live diagonal gets ``noise`` (...,)."""
    n = k.shape[-1]
    mm = (mask[:, None] & mask[None, :]).to(k.dtype)
    eye = torch.eye(n, dtype=k.dtype, device=k.device)
    return k * mm + eye * (1.0 - mm) + eye * mm * noise[..., None, None]


def _masked_kernel(
    x: torch.Tensor,
    params: GPHyperParams,
    mask: torch.Tensor,
    backend: str,
) -> torch.Tensor:
    """The factorize operand K̃ + σ²I (``masked_operand``). The kernel
    backend builds it in one ``matern52_operand`` launch from the rows, the
    GPHP table and the mask, bit for bit the composition around
    ``gram(backend="kernel")``."""
    if backend == "kernel":
        from repro_torch.kernels.matern52.ops import matern52_operand

        return matern52_operand(x, params, mask, _JITTER)
    k = gram(x, x, params, backend=backend)
    return masked_operand(k, mask, torch.exp(2.0 * params.log_noise) + _JITTER)


def _default_mask(x: torch.Tensor, mask):
    if mask is None:
        return torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    return mask


def log_marginal_likelihood(
    x: torch.Tensor,
    y: torch.Tensor,
    params: GPHyperParams,
    mask: Optional[torch.Tensor] = None,
    *,
    backend: str = "torch",
) -> torch.Tensor:
    """log p(y | X, θ) for the live rows. Scalar (or (S,) for sampled θ)."""
    mask = _default_mask(x, mask)
    y = torch.where(mask, y, torch.zeros_like(y))
    kmat = _masked_kernel(x, params, mask, backend)
    chol = cholesky(kmat)
    alpha = cho_solve(chol, y)
    quad = torch.sum(y * alpha, dim=-1)
    # masked rows contribute log(1)=0 to the logdet and 0 to the quad term.
    logdet = 2.0 * torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1
    )
    n_live = torch.sum(mask).to(y.dtype)
    return -0.5 * (quad + logdet + n_live * _LOG2PI)


def log_posterior_density(
    x: torch.Tensor,
    y: torch.Tensor,
    packed: torch.Tensor,
    bounds: GPHyperBounds,
    mask: Optional[torch.Tensor] = None,
    *,
    backend: str = "torch",
) -> torch.Tensor:
    """Unnormalized log posterior over the *packed* GPHP vector:
    MLL + weak Gaussian prior centered mid-box; −inf outside the box
    (the paper's hard stability bounds). A stack of packed vectors (R, D)
    gives (R,): one density per row (the MAP fit's restarts)."""
    d = x.shape[-1]
    f64 = dict(dtype=packed.dtype, device=packed.device)
    lower = torch.as_tensor(bounds.lower, **f64)
    upper = torch.as_tensor(bounds.upper, **f64)
    inside = torch.all((packed >= lower) & (packed <= upper), dim=-1)
    params = GPHyperParams.unpack(packed, d)
    mll = log_marginal_likelihood(x, y, params, mask, backend=backend)
    prior_std = torch.as_tensor(np.maximum(bounds.width / 4.0, 1e-6), **f64)
    center = torch.as_tensor(bounds.center, **f64)
    log_prior = -0.5 * torch.sum(((packed - center) / prior_std) ** 2, dim=-1)
    return torch.where(
        inside, mll + log_prior, torch.full_like(mll, -float("inf"))
    )


def _triangular_inverse(chol: torch.Tensor) -> torch.Tensor:
    """L⁻¹ for a (batch of) lower factor(s) — identity rows stay identity."""
    eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device)
    return torch.linalg.solve_triangular(
        chol, eye.expand(chol.shape), upper=False
    )


def fit_gp(
    x: torch.Tensor,
    y: torch.Tensor,
    params: GPHyperParams,
    mask: Optional[torch.Tensor] = None,
    *,
    backend: str = "torch",
    with_inverse: bool = False,
) -> GPPosterior:
    """Factorize the posterior for one GPHP setting (or, for parameters
    with a leading sample axis, for each of them)."""
    mask = _default_mask(x, mask)
    y = torch.where(mask, y, torch.zeros_like(y))
    kmat = _masked_kernel(x, params, mask, backend)
    chol = cholesky(kmat)
    alpha = cho_solve(chol, y)
    return GPPosterior(
        x_train=x,
        mask=mask,
        chol=chol,
        alpha=alpha,
        params=params,
        chol_inv=_triangular_inverse(chol) if with_inverse else None,
    )


def fit_posterior_batch(
    x: torch.Tensor,
    y: torch.Tensor,
    params_batch: GPHyperParams,
    mask: Optional[torch.Tensor] = None,
    *,
    backend: str = "torch",
    with_inverse: bool = False,
) -> GPPosterior:
    """Factorize once per MCMC sample (leading axis S on ``params_batch``)."""
    return fit_gp(
        x, y, params_batch, mask, backend=backend, with_inverse=with_inverse
    )


def predict(
    post: GPPosterior, x_star: torch.Tensor, *, backend: str = "torch"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior marginals at x_star: (mu, var), each (S, m) if the posterior
    holds S MCMC samples, else (m,). Variance includes the latent-f variance
    only (not observation noise), matching EI-on-f semantics."""
    k_star = gram(post.x_train, x_star, post.params, backend=backend)  # (.., n, m)
    k_star = k_star * post.mask[:, None].to(k_star.dtype)
    mu = torch.sum(k_star * post.alpha[..., :, None], dim=-2)  # (.., m)
    v = torch.linalg.solve_triangular(post.chol, k_star, upper=False)
    amp2 = torch.exp(2.0 * post.params.log_amplitude)[..., None]
    var = torch.clamp_min(amp2 - torch.sum(v * v, dim=-2), 1e-12)
    return mu, var
