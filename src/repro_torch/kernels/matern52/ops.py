"""Dispatchers for the Matérn-5/2 kernels: parameter packing and dtype.

Drop-in replacements for ``matern52_ard`` (``gram``) and its single row
(``gram_cross``). Like the TPU kernels they replace
(``src/repro/kernels/matern52/ops.py``), they compute in float32 and cast
the result back to the inputs' dtype — which is why the engine's
``fit_backend`` defaults to ``"torch"``: a float32 gram would perturb the
float64 slice-sampling chain. No row or feature padding is needed: the
kernels mask their ragged edges.

Parameters may carry a leading (S,) sample axis; all S sets go to one
launch.
"""

from __future__ import annotations

import torch

from repro_torch.core.gp.params import GPHyperParams
from repro_torch.kernels.matern52.kernel import (
    matern52_cross_kernel,
    matern52_gram_kernel,
)

__all__ = ["matern52_gram", "matern52_cross", "packed_params"]

_DTYPE = torch.float32  # the TPU kernels' dtype


def packed_params(params: GPHyperParams, warp: bool, dtype: torch.dtype):
    """(inv_ell, a, b, on, amp2) as (S, d) / (S,) tensors of ``dtype``."""
    batched = params.log_lengthscale.ndim == 2

    def lead(t):
        return t if batched else t[None]

    log_a = lead(params.log_warp_a)
    log_b = lead(params.log_warp_b)
    # cast, then exponentiate: the reference's packing order
    inv_ell = torch.exp(-lead(params.log_lengthscale).to(dtype))
    a = torch.exp(log_a.to(dtype))
    b = torch.exp(log_b.to(dtype))
    identity = (torch.abs(log_a) < 1e-7) & (torch.abs(log_b) < 1e-7)
    on = (~identity).to(dtype)
    if not warp:
        on = torch.zeros_like(on)
    amp2 = torch.exp(2.0 * lead(params.log_amplitude).to(dtype))
    return tuple(t.contiguous() for t in (inv_ell, a, b, on, amp2)), batched


def matern52_gram(
    x1: torch.Tensor,
    x2: torch.Tensor,
    params: GPHyperParams,
    *,
    warp: bool = True,
) -> torch.Tensor:
    """Same semantics and shapes as ``matern52_ard``: (n, m), or (S, n, m)
    for sampled parameters."""
    packed, batched = packed_params(params, warp, _DTYPE)
    out = matern52_gram_kernel(
        x1.to(_DTYPE).contiguous(), x2.to(_DTYPE).contiguous(), *packed
    ).to(x1.dtype)
    return out if batched else out[0]


def matern52_cross(
    x_new: torch.Tensor,
    x_train: torch.Tensor,
    params: GPHyperParams,
    *,
    warp: bool = True,
) -> torch.Tensor:
    """Cross-covariance row k(x_new, X): (d,), (n, d) -> (n,), or (S, n)."""
    packed, batched = packed_params(params, warp, _DTYPE)
    out = matern52_cross_kernel(
        x_new.to(_DTYPE).contiguous(), x_train.to(_DTYPE).contiguous(), *packed
    ).to(x_train.dtype)
    return out if batched else out[0]
