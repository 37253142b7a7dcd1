"""Covariance functions for the GP surrogate (paper §4.2).

Default: Matérn-5/2 with automatic relevance determination (ARD), the
"de-facto standard in most BO packages" per the paper (following Snoek et al.
2012). Input warping is fused here: K_θ(x, x') := k(ω(x), ω(x')).

``matern52_ard`` is the plain torch implementation (differentiable; the
acquisition refinement takes its gradients through it). ``gram`` and
``gram_rows`` dispatch ``backend="torch"`` to it and ``backend="kernel"`` to
the hand-written Matérn-5/2 kernels in ``repro_torch/kernels/matern52``
(float32, like the TPU kernels they replace).

Parameters may carry a leading (S,) sample axis; the gram then gets one too:
(S, n, m) instead of (n, m).
"""

from __future__ import annotations

import torch

from repro_torch.core.gp.params import GPHyperParams
from repro_torch.core.gp.warping import warp_inputs

__all__ = [
    "matern52_ard", "matern52_response", "sqdist", "gram", "gram_rows", "append_rows",
    "SQRT5",
]

SQRT5 = 2.2360679774997896


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distance: a (..., n, d), b (..., m, d) -> (..., n, m).

    Uses the explicit difference form, which is more numerically robust than
    the (||a||² + ||b||² − 2ab) expansion for the small-n gram matrices BO
    works with.
    """
    diff = a[..., :, None, :] - b[..., None, :, :]
    return torch.sum(diff * diff, dim=-1)


def _scaled_sqdist(
    x1: torch.Tensor, x2: torch.Tensor, log_ell: torch.Tensor
) -> torch.Tensor:
    """Pairwise squared distance after per-dim lengthscale scaling.

    x1: (..., n, d), x2: (..., m, d), log_ell: (..., d) -> (..., n, m).
    """
    inv_ell = torch.exp(-log_ell)[..., None, :]
    return sqdist(x1 * inv_ell, x2 * inv_ell)


def matern52_response(r2: torch.Tensor, amp2: torch.Tensor) -> torch.Tensor:
    """amp²·(1 + √5 r + 5/3 r²)·exp(−√5 r) of a squared distance r²."""
    # Safe sqrt: gradient at r=0 must be finite (diagonal entries).
    r = torch.sqrt(torch.clamp_min(r2, 1e-30))
    return amp2 * (1.0 + SQRT5 * r + (5.0 / 3.0) * r2) * torch.exp(-SQRT5 * r)


def matern52_ard(
    x1: torch.Tensor,
    x2: torch.Tensor,
    params: GPHyperParams,
    *,
    warp: bool = True,
) -> torch.Tensor:
    """Matérn-5/2 ARD gram matrix with fused Kumaraswamy warping.

    x1: (n, d), x2: (m, d) in the encoded unit cube -> (n, m), or
    (S, n, m) for parameters with a leading sample axis.
    """
    if warp:
        la = params.log_warp_a[..., None, :]
        lb = params.log_warp_b[..., None, :]
        x1 = warp_inputs(x1, la, lb)
        x2 = warp_inputs(x2, la, lb)
    r2 = _scaled_sqdist(x1, x2, params.log_lengthscale)
    amp2 = torch.exp(2.0 * params.log_amplitude)[..., None, None]
    return matern52_response(r2, amp2)


def gram(
    x1: torch.Tensor,
    x2: torch.Tensor,
    params: GPHyperParams,
    *,
    warp: bool = True,
    backend: str = "torch",
) -> torch.Tensor:
    """Gram-matrix dispatch: ``torch`` (plain composition) or ``kernel``
    (the hand-written Matérn-5/2 gram kernel)."""
    if backend == "torch":
        return matern52_ard(x1, x2, params, warp=warp)
    if backend == "kernel":
        from repro_torch.kernels.matern52.ops import matern52_gram

        return matern52_gram(x1, x2, params, warp=warp)
    raise ValueError(f"unknown gram backend {backend!r}")


def append_rows(
    x_new: torch.Tensor, x_train: torch.Tensor, idx: int, size: int
) -> torch.Tensor:
    """The ``size`` rows of a bucket after appending x_new (R, d) at rows
    idx, idx + 1, …: x_train[:idx], then x_new, then zero rows."""
    z = x_train.new_zeros((size, x_train.shape[-1]))
    z[:idx] = x_train[:idx]
    end = min(size, idx + x_new.shape[0])
    z[idx:end] = x_new[: end - idx].to(z.dtype)
    return z


def gram_rows(
    x_new: torch.Tensor,
    x_train: torch.Tensor,
    idx: int,
    size: int,
    params: GPHyperParams,
    *,
    warp: bool = True,
    backend: str = "torch",
) -> torch.Tensor:
    """Cross rows of appending x_new (R, d) at rows idx, idx + 1, … of a
    bucket: (R, size), or (S, R, size) for sampled parameters. Entry (r, j)
    is k(x_new_r, z_j) over the rows z of ``append_rows``; columns from
    idx + R on are 0. The append of row r reads columns [0, idx + r) of row
    r, so one call serves a whole pending set, and each row equals the cross
    row of its own append (row r against the bucket after rows 0…r−1).

    The rank-1 posterior append (``repro_torch.core.gp.incremental``) needs
    only these rows, not the full n×n gram; the kernel backend dispatches
    to the ``matern52_cross`` kernel: one launch for all rows and samples."""
    if backend == "kernel":
        from repro_torch.kernels.matern52.ops import matern52_rows

        return matern52_rows(x_new, x_train, idx, size, params, warp=warp)
    if backend != "torch":
        raise ValueError(f"unknown gram backend {backend!r}")
    out = matern52_ard(x_new, append_rows(x_new, x_train, idx, size), params, warp=warp)
    out[..., idx + x_new.shape[0]:] = 0.0
    return out
