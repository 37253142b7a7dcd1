"""Incremental (rank-1) updates of a Cholesky-factorized GP posterior.

Appending one observation changes K̃ = K + σ²I by one bordered row/column,
and the masked-kernel convention of ``repro_torch.core.gp.gp`` makes the
update exact on *padded* buckets too: masked rows of K̃ are identity rows, so
the padded factor is block-diagonal ``[[L_live, 0], [0, I]]`` and appending
the next live row only rewrites row ``n_live`` of L:

    L[n, :n] = w          where  L_live · w = k(x_new, X_live)
    L[n, n]  = √(k_nn − wᵀw)

— one triangular solve, O(n²) per GPHP sample. ``alpha = K̃⁻¹y`` is *not*
updated incrementally: the running standardization rescales every target when
an observation arrives, so ``refresh_alpha`` recomputes it from the cached
factor (two triangular solves, also O(n²)).

Invariant required by ``posterior_append``: live rows form a prefix of the
padded arrays, and the caller passes the append index ``idx`` — the live
count, which it knows on the host (``sum(mask)``, read back from the card,
would cost a synchronization each append). ``ObservationStore``
guarantees the prefix. The S GPHP samples are a leading batch axis
throughout.

The cross-covariance rows k(x_new, X) dispatch through
``repro_torch.core.gp.kernels.gram_rows`` — on the kernel backend that is
the ``matern52_cross`` kernel, one launch for all S samples and for every
row of a pending set: a caller that folds several rows computes them once
and hands each append its row as ``cross``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.gp.gp import _JITTER, GPPosterior, cho_solve, cholesky
from repro_torch.core.gp.kernels import gram_rows

__all__ = [
    "cholesky_append_row",
    "cholesky_append_block",
    "cholesky_delete_row",
    "posterior_append",
    "posterior_append_block",
    "posterior_delete",
    "refresh_alpha",
    "grow_posterior",
]


def _border_parts(
    chol: torch.Tensor, k_row: torch.Tensor, k_diag: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(w, l22) of the bordered factor [[L, 0], [wᵀ, l22]]: one triangular
    solve, O(n²). chol (..., n, n), k_row (..., n), k_diag (...)."""
    w = torch.linalg.solve_triangular(chol, k_row[..., None], upper=False)[..., 0]
    # w is exact on live coords and 0 on masked ones (identity rows solve to 0)
    l22 = torch.sqrt(torch.clamp_min(k_diag - torch.sum(w * w, dim=-1), _JITTER))
    return w, l22


def _set_border_row(
    chol: torch.Tensor, w: torch.Tensor, l22: torch.Tensor, idx: int
) -> torch.Tensor:
    """Write the border [w, l22, 0…] into row ``idx`` of the factor."""
    cols = torch.arange(chol.shape[-1], device=chol.device)
    new_row = torch.where(
        cols == idx,
        l22[..., None],
        torch.where(cols < idx, w, torch.zeros_like(w)),
    )
    out = chol.clone()
    out[..., idx, :] = new_row
    return out


def cholesky_append_row(
    chol: torch.Tensor,  # (n, n) lower factor, identity on masked rows
    k_row: torch.Tensor,  # (n,) cross-covariances, 0 at masked columns
    k_diag: torch.Tensor,  # () new diagonal entry k(x,x) + σ² + jitter
    idx: int,  # index of the row being appended (= current n_live)
) -> torch.Tensor:
    """Rank-1 border update: return the factor with row ``idx`` replaced by
    [w, √(k_diag − wᵀw), 0…]. O(n²) vs O(n³) for refactorization."""
    w, l22 = _border_parts(chol, k_row, k_diag)
    return _set_border_row(chol, w, l22, int(idx))


def _inverse_append_row(
    linv: torch.Tensor, w: torch.Tensor, l22: torch.Tensor, idx: int
) -> torch.Tensor:
    """The inverse of the bordered factor is itself a border update:

        [[L, 0], [wᵀ, l22]]⁻¹ = [[L⁻¹, 0], [−wᵀL⁻¹/l22, 1/l22]]

    so the cached L⁻¹ stays O(n²)-maintained, like the factor."""
    row = torch.matmul(w[..., None, :], linv)[..., 0, :]
    return _set_border_row(linv, -row / l22[..., None], 1.0 / l22, idx)


def posterior_append(
    post: GPPosterior,
    x_new: torch.Tensor,  # (d,) encoded new observation
    *,
    idx: int,  # the append index: the live count, sum(post.mask)
    cross: torch.Tensor | None = None,  # (..., n) its cross row, if computed
    backend: str = "torch",
) -> GPPosterior:
    """Fold one observation's input into the factorization. ``cross`` is the
    row of ``gram_rows`` for this append on the bucket's n columns (columns
    from ``idx`` on are ignored); without it, it is computed here. ``alpha``
    is left stale — call ``refresh_alpha`` with the new standardized
    targets."""
    params = post.params
    n = post.x_train.shape[0]
    if cross is None:
        cross = gram_rows(x_new[None], post.x_train, idx, n, params,
                          backend=backend)[..., 0, :]
    k_row = torch.where(post.mask, cross, torch.zeros_like(cross))
    noise = torch.exp(2.0 * params.log_noise) + _JITTER
    k_diag = torch.exp(2.0 * params.log_amplitude) + noise
    w, l22 = _border_parts(post.chol, k_row, k_diag)
    chol = _set_border_row(post.chol, w, l22, idx)
    linv = (
        None
        if post.chol_inv is None
        else _inverse_append_row(post.chol_inv, w, l22, idx)
    )
    x_train = post.x_train.clone()
    x_train[idx] = x_new.to(x_train.dtype)
    mask = post.mask.clone()
    mask[idx] = True
    return GPPosterior(
        x_train=x_train,
        mask=mask,
        chol=chol,
        alpha=post.alpha,
        params=params,
        chol_inv=linv,
    )


def refresh_alpha(post: GPPosterior, y: torch.Tensor) -> GPPosterior:
    """Recompute alpha = K̃⁻¹y from the cached factor (O(n²) per sample).
    Needed after every append *and* every restandardization of y."""
    y = torch.where(post.mask, y, torch.zeros_like(y))
    return post._replace(alpha=cho_solve(post.chol, y))


def cholesky_append_block(
    chol: torch.Tensor,  # (..., n, n) lower factor, identity on masked rows
    k_rows: torch.Tensor,  # (..., k, n) cross-covariances, 0 at masked cols
    k_block: torch.Tensor,  # (..., k, k) gram among the new rows incl. noise
    idx: int,  # index of the first appended row (= current n_live)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank-k border append: one *blocked* triangular solve instead of k
    rank-1 borders. Returns ``(chol', W, L22)`` where the bordered factor is

        [[L, 0], [Wᵀ, L22]],  L·W = K_crossᵀ,  L22·L22ᵀ = K_new − WᵀW
    """
    k = k_rows.shape[-2]
    w = torch.linalg.solve_triangular(
        chol, k_rows.transpose(-1, -2), upper=False
    )  # (..., n, k)
    s22 = k_block - w.transpose(-1, -2) @ w
    # ``k_block``'s diagonal already carries noise + jitter (same as the
    # rank-1 border's k_diag), so no extra regularization is added here.
    l22 = cholesky(s22)
    out = chol.clone()
    rows = slice(idx, idx + k)
    out[..., rows, :] = 0.0
    out[..., rows, :idx] = w.transpose(-1, -2)[..., :, :idx]
    out[..., rows, idx : idx + k] = torch.tril(l22)
    return out, w, l22


def _inverse_append_block(
    linv: torch.Tensor,  # (..., n, n) cached L⁻¹
    w: torch.Tensor,  # (..., n, k) blocked border solve
    l22: torch.Tensor,  # (..., k, k) new diagonal block of the factor
    idx: int,  # index of the first appended row
) -> torch.Tensor:
    """Blockwise border of the inverse:

        [[L, 0], [Wᵀ, L22]]⁻¹ = [[L⁻¹, 0], [−L22⁻¹WᵀL⁻¹, L22⁻¹]]
    """
    k = l22.shape[-1]
    bottom_left = -torch.linalg.solve_triangular(
        l22, w.transpose(-1, -2) @ linv, upper=False
    )  # (..., k, n); vanishes on columns ≥ idx
    eye = torch.eye(k, dtype=l22.dtype, device=l22.device)
    l22_inv = torch.linalg.solve_triangular(l22, eye.expand(l22.shape), upper=False)
    out = linv.clone()
    rows = slice(idx, idx + k)
    out[..., rows, :] = 0.0
    out[..., rows, :idx] = bottom_left[..., :, :idx]
    out[..., rows, idx : idx + k] = torch.tril(l22_inv)
    return out


def posterior_append_block(
    post: GPPosterior,
    x_new: torch.Tensor,  # (k, d) encoded new observations
    *,
    idx: int,  # index of the first appended row: the live count
    backend: str = "torch",
) -> GPPosterior:
    """Fold k observations' inputs into the factorization with one blocked
    solve per GPHP sample (the rank-k analogue of ``posterior_append``).
    Its cross rows and its k×k block come from one ``gram_rows`` call.
    ``alpha`` is left stale — call ``refresh_alpha`` with the new targets.
    The caller must have grown the bucket to hold the k extra rows."""
    k = x_new.shape[0]
    params = post.params
    rows = gram_rows(x_new, post.x_train, idx, post.x_train.shape[0], params,
                     backend=backend)  # (..., k, n)
    k_rows = torch.where(post.mask, rows, torch.zeros_like(rows))
    noise = (torch.exp(2.0 * params.log_noise) + _JITTER)[..., None, None]
    eye = torch.eye(k, dtype=rows.dtype, device=rows.device)
    k_block = rows[..., idx : idx + k] + noise * eye
    chol, w, l22 = cholesky_append_block(post.chol, k_rows, k_block, idx)
    linv = (
        None
        if post.chol_inv is None
        else _inverse_append_block(post.chol_inv, w, l22, idx)
    )
    x_train = post.x_train.clone()
    x_train[idx : idx + k] = x_new.to(x_train.dtype)
    mask = post.mask.clone()
    mask[idx : idx + k] = True
    return GPPosterior(
        x_train=x_train,
        mask=mask,
        chol=chol,
        alpha=post.alpha,
        params=params,
        chol_inv=linv,
    )


def _chol_rank1_update_np(f: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Classic rank-1 Cholesky *update*: returns F' with F'F'ᵀ = FFᵀ + vvᵀ
    (numpy, O(k²)). Identity rows with v = 0 stay identity, preserving the
    masked-padding convention."""
    f = f.copy()
    v = v.copy()
    k = f.shape[0]
    for i in range(k):
        r = float(np.hypot(f[i, i], v[i]))
        c, s = r / f[i, i], v[i] / f[i, i]
        f[i, i] = r
        if i + 1 < k:
            f[i + 1 :, i] = (f[i + 1 :, i] + s * v[i + 1 :]) / c
            v[i + 1 :] = c * v[i + 1 :] - s * f[i + 1 :, i]
    return f


def cholesky_delete_row(
    chol: np.ndarray,  # (n, n) lower factor, identity on masked rows
    idx: int,  # row/col being deleted (< n_live)
    n_live: int,  # live rows before the deletion
    linv: "np.ndarray | None" = None,  # cached L⁻¹ to maintain alongside
) -> tuple[np.ndarray, "np.ndarray | None"]:
    """Rank-1 Cholesky *downdate*: the factor of K with row/col ``idx``
    deleted, live rows re-packed as a prefix and row ``n_live−1`` reset to
    identity padding. With L partitioned at ``idx``

        L = [[A, 0, 0], [bᵀ, d, 0], [C, e, F]]

    the deleted row only affects the trailing block: F'F'ᵀ = FFᵀ + eeᵀ, one
    O(k²) rank-1 update (k = n_live − idx − 1). The cached inverse is
    rebuilt blockwise: [[A,0],[C,F']]⁻¹ = [[A⁻¹,0],[−F'⁻¹CA⁻¹,F'⁻¹]].

    Numpy in, numpy out (deletions are rare corrections, made on the host)."""
    if not 0 <= idx < n_live:
        raise IndexError(f"idx {idx} out of live range [0, {n_live})")
    l = np.asarray(chol, dtype=np.float64)
    k = n_live - idx - 1
    out = l.copy()
    fp = None
    if k > 0:
        f = l[idx + 1 : n_live, idx + 1 : n_live]
        e = l[idx + 1 : n_live, idx]
        fp = _chol_rank1_update_np(f, e)
        out[idx : n_live - 1, :idx] = l[idx + 1 : n_live, :idx]
        out[idx : n_live - 1, idx:] = 0.0
        out[idx : n_live - 1, idx : n_live - 1] = fp
    out[n_live - 1, :] = 0.0
    out[:, n_live - 1] = 0.0
    out[n_live - 1, n_live - 1] = 1.0

    new_linv = None
    if linv is not None:
        li = np.asarray(linv, dtype=np.float64)
        new_linv = li.copy()
        if k > 0:
            a_inv = li[:idx, :idx]
            c = l[idx + 1 : n_live, :idx]
            fp_inv = _tri_inv_np(fp)
            new_linv[idx : n_live - 1, :idx] = -fp_inv @ (c @ a_inv)
            new_linv[idx : n_live - 1, idx:] = 0.0
            new_linv[idx : n_live - 1, idx : n_live - 1] = fp_inv
        new_linv[n_live - 1, :] = 0.0
        new_linv[:, n_live - 1] = 0.0
        new_linv[n_live - 1, n_live - 1] = 1.0
    return out, new_linv


def _tri_inv_np(l: np.ndarray) -> np.ndarray:
    """Inverse of a lower-triangular matrix by forward substitution (numpy)."""
    k = l.shape[0]
    inv = np.zeros_like(l)
    for j in range(k):
        inv[j, j] = 1.0 / l[j, j]
        for i in range(j + 1, k):
            inv[i, j] = -np.dot(l[i, j:i], inv[j:i, j]) / l[i, i]
    return inv


def posterior_delete(post: GPPosterior, row: int) -> GPPosterior:
    """Remove live row ``row`` from a factorized posterior via the rank-1
    downdate (per GPHP sample), shifting the suffix up so live rows stay a
    prefix. ``alpha`` is left stale — call ``refresh_alpha`` with the new
    targets. Runs in numpy on the host and moves the result back."""
    dev = post.x_train.device
    mask = post.mask.cpu().numpy()
    n_live = int(mask.sum())
    if not 0 <= row < n_live:
        raise IndexError(f"row {row} out of live range [0, {n_live})")
    x = post.x_train.cpu().numpy().copy()
    x[row : n_live - 1] = x[row + 1 : n_live]
    x[n_live - 1] = 0.0
    mask = mask.copy()
    mask[n_live - 1] = False

    batched = post.chol.ndim == 3
    chols = post.chol.cpu().numpy()
    linvs = None if post.chol_inv is None else post.chol_inv.cpu().numpy()
    if not batched:
        chols = chols[None]
        linvs = None if linvs is None else linvs[None]
    new_chols = np.empty_like(chols)
    new_linvs = None if linvs is None else np.empty_like(linvs)
    for s in range(chols.shape[0]):
        c, li = cholesky_delete_row(
            chols[s], row, n_live, None if linvs is None else linvs[s]
        )
        new_chols[s] = c
        if new_linvs is not None:
            new_linvs[s] = li
    if not batched:
        new_chols = new_chols[0]
        new_linvs = None if new_linvs is None else new_linvs[0]
    return GPPosterior(
        x_train=torch.as_tensor(x).to(dev),
        mask=torch.as_tensor(mask).to(dev),
        chol=torch.as_tensor(new_chols).to(dev),
        alpha=post.alpha,
        params=post.params,
        chol_inv=None if new_linvs is None else torch.as_tensor(new_linvs).to(dev),
    )


def grow_posterior(post: GPPosterior, new_size: int) -> GPPosterior:
    """Re-pad a posterior to a larger shape bucket without refactorizing:
    masked rows are identity rows, so the factor grows by an identity block
    (and block-diag inverses compose, so the cached L⁻¹ grows the same way)."""
    n = post.x_train.shape[0]
    pad = new_size - n
    if pad <= 0:
        return post
    x = torch.nn.functional.pad(post.x_train, (0, 0, 0, pad))
    mask = torch.nn.functional.pad(post.mask, (0, pad))

    def grow_tri(t):
        t = torch.nn.functional.pad(t, (0, pad, 0, pad))
        diag = torch.arange(n, new_size, device=t.device)
        t[..., diag, diag] = 1.0
        return t

    chol = grow_tri(post.chol)
    linv = None if post.chol_inv is None else grow_tri(post.chol_inv)
    alpha = torch.nn.functional.pad(post.alpha, (0, pad))
    return GPPosterior(
        x_train=x, mask=mask, chol=chol, alpha=alpha, params=post.params,
        chol_inv=linv,
    )
