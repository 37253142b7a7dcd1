"""Plain PyTorch versions of the Matérn-5/2 kernels (``csrc/matern52.cu``).

The gram takes packed inputs: x (rows, d); per-set parameters inv_ell, a,
b, on (S, d) and amp2 (S,). The cross rows and the factorize operand take
what the engine holds — float64 rows and the (S, 3d + 2) table of log GPHPs
— and pack it here with ``packed_params``, as the kernels pack it in the
launch. Built from the engine's own torch arithmetic (``kumaraswamy_cdf``,
``sqdist``, ``matern52_response``, ``masked_operand``); the kernels sum the
squared distance in another order, which moves the gram only by rounding.
"""

from __future__ import annotations

import torch

from repro_torch.core.gp.gp import masked_operand
from repro_torch.core.gp.kernels import append_rows, matern52_response, sqdist
from repro_torch.core.gp.params import GPHyperParams
from repro_torch.core.gp.warping import kumaraswamy_cdf

__all__ = [
    "packed_params",
    "matern52_gram_plain",
    "matern52_cross_plain",
    "matern52_operand_plain",
    "warp_scale",
]


def packed_params(params: GPHyperParams, warp: bool, dtype: torch.dtype):
    """(inv_ell, a, b, on, amp2) as (S, d) / (S,) tensors of ``dtype``, and
    whether ``params`` carried the sample axis."""
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


def warp_scale(x, a, b, on, inv_ell) -> torch.Tensor:
    """Packed warp: x (r, d) → (S, r, d), the Kumaraswamy CDF where ``on``
    is 1 (identity where it is 0), times 1/ℓ."""
    p = [t[:, None, :] for t in (a, b, on, inv_ell)]
    w = kumaraswamy_cdf(x[None], p[0], p[1])
    return torch.where(p[2] > 0, w, x[None]) * p[3]


def matern52_gram_plain(x1, x2, inv_ell, a, b, on, amp2) -> torch.Tensor:
    """(n, d) × (m, d) → (S, n, m)."""
    s1 = warp_scale(x1, a, b, on, inv_ell)
    s2 = warp_scale(x2, a, b, on, inv_ell)
    return matern52_response(sqdist(s1, s2), amp2[:, None, None])


def _table_gram(x1, x2, table, warp):
    """The float32 gram of float64 rows under the table's sets, as float64."""
    packed, _ = packed_params(GPHyperParams.unpack(table, x1.shape[-1]), warp,
                              torch.float32)
    return matern52_gram_plain(x1.float(), x2.float(), *packed).to(x1.dtype)


def matern52_cross_plain(x_new, x_train, table, idx, m, warp=True) -> torch.Tensor:
    """Cross rows of appending x_new (R, d) at rows idx, idx + 1, … of a
    bucket of m: (S, R, m), zero from column idx + R on."""
    out = _table_gram(x_new, append_rows(x_new, x_train, idx, m), table, warp)
    out[..., idx + x_new.shape[0]:] = 0.0
    return out


def matern52_operand_plain(x, table, mask, jitter, warp=True) -> torch.Tensor:
    """The factorize operand of rows x (n, d) under mask (n,): (S, n, n)."""
    noise = torch.exp(2.0 * GPHyperParams.unpack(table, x.shape[-1]).log_noise) + jitter
    return masked_operand(_table_gram(x, x, table, warp), mask, noise)
