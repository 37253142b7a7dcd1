"""Backend dispatchers for fused anchor scoring: ``acq_score`` and
``acq_score_multi``.

``backend="torch"`` is the plain composition (``gp.predict`` + closed-form
EI/LCB; ``gp.multi.predict_heads`` + the multi-head closed forms).
``backend="kernel"`` packs the posterior in the reference's layout
(``src/repro/kernels/acq_score/ops.py``) and calls the fused kernel: one
pass per decision over the anchor grid, K* never written to device memory.

The kernel's solve is the product L⁻¹K*ᵀ. The inverted factor comes from the
posterior's ``chol_inv`` cache when the engine built one
(``fit_posterior_batch(with_inverse=True)`` + O(n²) maintenance in the
rank-1 append); otherwise it is computed here, once per call.

Padding contract (the reference's): train rows are padded to a multiple of 8
with mask 0, α 0 and an identity block in L⁻¹, so padded rows are exactly
inert; features are padded to a multiple of 8 with 1/ℓ = 0, so padded
features add nothing to distances; the head block α (S, M, n) is padded
with zeros like α. Anchors are not padded: the kernel masks its ragged last
tile itself.

Dtype: the anchors' own (float64 on the engine's path); ``pack_inputs``
can cast the packed inputs, e.g. to float32.
"""

from __future__ import annotations

import torch

from repro_torch.core import acquisition as A
from repro_torch.core.gp.gp import GPPosterior, _triangular_inverse, predict
from repro_torch.core.gp.multi import MultiOutputPosterior, predict_heads
from repro_torch.core.gp.params import GPHyperParams
from repro_torch.kernels.acq_score.kernel import (
    MULTI_MODES,
    acq_score_kernel,
    acq_score_multi_kernel,
)
from repro_torch.kernels.acq_score.plain import multi_closed_form

__all__ = ["acq_score", "acq_score_multi", "pack_inputs", "pack_multi_inputs"]


def _pad_to(x: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    pad = size - x.shape[dim]
    if pad <= 0:
        return x
    widths = [0, 0] * x.ndim
    widths[2 * (x.ndim - 1 - dim) + 1] = pad
    return torch.nn.functional.pad(x, widths)


def _packed_params_batch(params: GPHyperParams, dpad: int, dt) -> tuple:
    """(inv_ell, a, b, on, amp2) in the kernel's (S, dpad) / (S,) layout."""
    inv_ell = torch.exp(-params.log_lengthscale.to(dt))
    a = torch.exp(params.log_warp_a.to(dt))
    b = torch.exp(params.log_warp_b.to(dt))
    identity = (torch.abs(params.log_warp_a) < 1e-7) & (
        torch.abs(params.log_warp_b) < 1e-7
    )
    on = (~identity).to(dt)
    # padded features: inv_ell = 0 ⇒ zero contribution to distances
    packed = [_pad_to(t, dpad, 1) for t in (inv_ell, a, b, on)]
    amp2 = torch.exp(2.0 * params.log_amplitude.to(dt))
    return tuple(t.contiguous() for t in (*packed, amp2))


def pack_inputs(post: GPPosterior, x_star: torch.Tensor, dtype=None) -> tuple:
    """The kernel's ten tensor inputs for ``post`` and anchors ``x_star``
    (the posterior must carry a leading sample axis)."""
    m, d = x_star.shape
    n = post.chol.shape[-1]
    npad = max(8, -(-n // 8) * 8)
    dpad = max(8, -(-d // 8) * 8)
    dt = x_star.dtype if dtype is None else dtype

    anchors = _pad_to(x_star.to(dt), dpad, 1)
    xt = _pad_to(_pad_to(post.x_train.to(dt), npad, 0), dpad, 1)
    mask = _pad_to(post.mask.to(dt), npad, 0)

    # identity-extend the (inverted) factor over padded rows; block-diagonal
    # triangular matrices invert blockwise, so padding and inversion commute.
    def ident_pad(t):
        t = _pad_to(_pad_to(t.to(dt), npad, 1), npad, 2)
        if npad > n:
            t = t.clone()
            diag = torch.arange(n, npad, device=t.device)
            t[:, diag, diag] = 1.0
        return t

    if post.chol_inv is not None:
        linv = ident_pad(post.chol_inv)
    else:
        linv = _triangular_inverse(ident_pad(post.chol))
    alphap = _pad_to(post.alpha.to(dt), npad, 1)
    params = _packed_params_batch(post.params, dpad, dt)
    return tuple(
        t.contiguous() for t in (anchors, xt, linv, alphap, mask, *params)
    )


def acq_score(
    post: GPPosterior,
    x_star: torch.Tensor,  # (m, d) anchor locations in the unit cube
    y_best,  # scalar: best standardized observation
    *,
    acq: str = "ei",
    kappa: float = 2.0,
    backend: str = "kernel",
) -> torch.Tensor:
    """Acquisition values at ``x_star``: (S, m) if the posterior carries S
    GPHP samples, else (m,). Larger is better. ``acq``: "ei" | "lcb"."""
    if acq not in ("ei", "lcb"):
        raise ValueError(f"unsupported acquisition {acq!r}")
    if backend == "torch":
        mu, var = predict(post, x_star, backend="torch")
        if acq == "ei":
            return A.expected_improvement(mu, var, y_best)
        return A.lcb(mu, var, kappa)
    if backend != "kernel":
        raise ValueError(f"unknown acq_score backend {backend!r}")

    batched = post.chol.ndim == 3
    out = acq_score_kernel(
        *pack_inputs(_with_sample_axis(post), x_star), float(y_best),
        float(kappa), acq,
    ).to(x_star.dtype)
    return out if batched else out[0]


def _with_sample_axis(post: GPPosterior) -> GPPosterior:
    if post.chol.ndim == 3:
        return post
    return GPPosterior(
        x_train=post.x_train,
        mask=post.mask,
        chol=post.chol[None],
        alpha=post.alpha[None],
        params=GPHyperParams(*(p[None] for p in post.params)),
        chol_inv=None if post.chol_inv is None else post.chol_inv[None],
    )


def pack_multi_inputs(post: GPPosterior, head, x_star: torch.Tensor, mode: str,
                      dtype=None) -> tuple:
    """The multi-head kernel's arguments for ``post``, ``head`` (a
    ``MultiMetricHead``) and anchors ``x_star``: the thirteen tensors and
    then ``y_best``, ``has_feasible``, ``mode``, ``num_con``."""
    shared = pack_inputs(post, x_star, dtype)
    dt = shared[0].dtype
    npad = shared[1].shape[0]
    alphas = _pad_to(head.alphas.to(dt), npad, 2).contiguous()
    num_con = int(head.t_std.shape[0])
    dev = x_star.device
    tcon = (head.t_std.to(dt) if num_con else torch.zeros(1, dtype=dt, device=dev))
    if mode == "constrained":
        # the reference's dummies: weights (1, 1), incumbents (1,)
        weights = torch.zeros((1, 1), dtype=dt, device=dev)
        ybw = torch.zeros(1, dtype=dt, device=dev)
    else:
        weights = head.weights.to(dt)
        ybw = head.y_best_w.to(dt).reshape(-1)
    tensors = (shared[:3] + (alphas,) + shared[4:]
               + tuple(t.contiguous() for t in (tcon, weights, ybw)))
    return tensors + (float(head.y_best), bool(head.has_feasible), mode, num_con)


def acq_score_multi(
    post: GPPosterior,
    head,  # repro_torch.core.optimize_acq.MultiMetricHead
    x_star: torch.Tensor,  # (m, d) anchor locations in the unit cube
    *,
    mode: str = "constrained",
    backend: str = "kernel",
) -> torch.Tensor:
    """Multi-head acquisition values at ``x_star``: (S, m), larger is
    better. ``mode``: "constrained" (EI₀ · Π Φ feasibility) | "pareto"
    (random-scalarization EI averaged over the head's weight draws) |
    "rungs" (resource-weighted per-head EI over rung heads) | "cost"
    (EI on head 0 discounted by exp(−η · mean of the standardized log-cost
    head 1), η in ``weights[0, 0]``).

    ``backend="torch"`` is the composition (``gp.multi.predict_heads`` +
    ``multimetric.acquisition``); ``backend="kernel"`` runs the fused
    kernel: warp + cross-gram + cached-inverse solve once per (GPHP sample ×
    anchor tile), the extra heads amortized as matvecs against the shared
    gram."""
    if mode not in MULTI_MODES:
        raise ValueError(f"unsupported mode {mode!r}")
    if backend == "torch":
        mu, var = predict_heads(
            MultiOutputPosterior(post, head.alphas), x_star, backend="torch"
        )
        return multi_closed_form(mu, var, mode, head.t_std, head.y_best,
                                 head.has_feasible, head.weights, head.y_best_w)
    if backend != "kernel":
        raise ValueError(f"unknown acq_score backend {backend!r}")
    args = pack_multi_inputs(_with_sample_axis(post), head, x_star, mode)
    return acq_score_multi_kernel(*args).to(x_star.dtype)
