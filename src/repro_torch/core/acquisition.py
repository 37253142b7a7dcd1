"""Acquisition functions (paper §4.3). Minimization convention throughout.

* **Expected improvement (EI)** — AMT's default. Closed form under the
  Gaussian marginal: with γ = (y* − μ)/σ,  EI = σ·(γΦ(γ) + φ(γ)).
* **LCB** — lower confidence bound μ − κσ (paper cites UCB-family as related).
* **Thompson-style sampling** — the paper's approximation: draw marginal
  samples N(μ(x), σ²(x)) at a dense Sobol anchor set (exact joint-posterior
  Thompson sampling is intractable).

All functions accept per-MCMC-sample moments of shape (S, m) and integrate the
acquisition over the GPHP posterior by averaging over S (Snoek et al. 2012).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng

__all__ = ["expected_improvement", "lcb", "thompson_draws", "integrate_over_samples"]

_SQRT2 = 1.4142135623730951
_INV_SQRT2PI = 0.3989422804014327


def _norm_pdf(z: torch.Tensor) -> torch.Tensor:
    return _INV_SQRT2PI * torch.exp(-0.5 * z * z)


def _norm_cdf(z: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(z / _SQRT2))


def expected_improvement(
    mu: torch.Tensor, var: torch.Tensor, y_best
) -> torch.Tensor:
    """EI(x) = E[max(0, y* − y(x))] for minimization. Shapes broadcast.

    Clamped at 0: the closed form is non-negative analytically, but the
    γΦ(γ) + φ(γ) cancellation can round to ~−1e-17 for γ ≪ 0."""
    sigma = torch.sqrt(torch.clamp_min(var, 1e-16))
    gamma = (y_best - mu) / sigma
    ei = sigma * (gamma * _norm_cdf(gamma) + _norm_pdf(gamma))
    return torch.maximum(ei, torch.zeros_like(ei))


def lcb(mu: torch.Tensor, var: torch.Tensor, kappa: float = 2.0) -> torch.Tensor:
    """Negated lower confidence bound, so that *larger is better* like EI."""
    return -(mu - kappa * torch.sqrt(torch.clamp_min(var, 1e-16)))


def thompson_draws(
    mu: torch.Tensor, var: torch.Tensor, key: np.ndarray, shape=None
) -> torch.Tensor:
    """Marginal Thompson draws at anchor locations; (S, m) -> (S, m).
    The *minimum* draw per sample is the Thompson choice. The normal draws
    come from the reference's key stream (``prng.normal``); ``shape``
    (broadcastable to ``mu``) overrides the draw shape."""
    shape = tuple(mu.shape) if shape is None else tuple(shape)
    eps = torch.as_tensor(prng.normal(key, shape), dtype=mu.dtype)
    return mu + torch.sqrt(torch.clamp_min(var, 1e-16)) * eps.to(mu.device)


def integrate_over_samples(acq_values: torch.Tensor) -> torch.Tensor:
    """Average an (S, m) acquisition over the GPHP MCMC samples -> (m,)."""
    if acq_values.ndim == 1:
        return acq_values
    return torch.mean(acq_values, dim=0)
