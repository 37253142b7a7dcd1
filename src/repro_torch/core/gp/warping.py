"""Kumaraswamy-CDF input warping (paper §4.2, following Snoek et al. 2014).

    ω(x_j) = 1 - (1 - x_j^{a_j})^{b_j},   x_j ∈ [0, 1]

with (a_j, b_j) treated as extra GPHPs (merged into θ; see ``params.py``).
The warp is applied entry-wise to the encoded inputs before the kernel, i.e.
K(x, x') := K(ω(x), ω(x')) — the "overloaded covariance" of the paper.

``clip`` is max-then-min, as ``jnp.clip``, so a gradient at a clip boundary
splits the way the JAX package's does.
"""

from __future__ import annotations

import torch

__all__ = ["kumaraswamy_cdf", "warp_inputs", "clip"]

_EPS = 1e-6


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    # torch.full fills on the device; torch.tensor(lo, device=...) would copy
    # from the host and synchronize the stream on every call.
    lo_t = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi_t = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def kumaraswamy_cdf(
    x: torch.Tensor, a: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Elementwise Kumaraswamy CDF, numerically safe at the cube boundary.

    x: (..., d) in [0,1];  a, b: broadcastable positive shapes.
    """
    x = clip(x, _EPS, 1.0 - _EPS)
    # x^a = exp(a log x): stable since x is clipped away from 0.
    xa = torch.exp(a * torch.log(x))
    xa = clip(xa, _EPS, 1.0 - _EPS)
    return 1.0 - torch.exp(b * torch.log1p(-xa))


def warp_inputs(
    x: torch.Tensor,
    log_a: torch.Tensor,
    log_b: torch.Tensor,
) -> torch.Tensor:
    """Apply the entry-wise warp ω to encoded inputs.

    x: (..., d) in the unit cube. log_a/log_b: (..., d) log-shapes,
    broadcastable against x; dims pinned to 0 (a=b=1) are made literally
    identity so one-hot dims are untouched.
    """
    a = torch.exp(log_a)
    b = torch.exp(log_b)
    warped = kumaraswamy_cdf(x, a, b)
    identity = (torch.abs(log_a) < 1e-7) & (torch.abs(log_b) < 1e-7)
    return torch.where(identity, x, warped)
