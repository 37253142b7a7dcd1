"""Dispatchers for the Matérn-5/2 kernels: parameter layout and dtype.

``matern52_gram`` is a drop-in for ``matern52_ard``: like the TPU kernel it
replaces (``src/repro/kernels/matern52/ops.py``) it computes in float32 and
casts the result back to the inputs' dtype — which is why the engine's
``fit_backend`` defaults to ``"torch"``: a float32 gram would perturb the
float64 slice-sampling chain. ``matern52_rows`` (the cross rows of an
append, ``gram_rows``) and ``matern52_operand`` (the factorize operand,
``gp._masked_kernel``) hand the kernel the engine's own float64 tensors —
the rows, the GPHP table the parameters are views of, the mask — and the
launch packs and casts them itself. No row or feature padding is needed:
the kernels mask their ragged edges.

Parameters may carry a leading (S,) sample axis; all S sets go to one
launch.
"""

from __future__ import annotations

import torch

from repro_torch.core.gp.params import GPHyperParams
from repro_torch.kernels.matern52.kernel import (
    matern52_cross_kernel,
    matern52_gram_kernel,
    matern52_operand_kernel,
)
from repro_torch.kernels.matern52.plain import packed_params

__all__ = [
    "matern52_gram", "matern52_rows", "matern52_operand", "packed_params", "param_table",
]

_DTYPE = torch.float32  # the TPU kernels' dtype


def _same_view(f: torch.Tensor, e: torch.Tensor) -> bool:
    """Whether f is the view e of e's storage (strides of size-1 dims aside)."""
    return (
        f.dtype == e.dtype
        and f.untyped_storage().data_ptr() == e.untyped_storage().data_ptr()
        and f.storage_offset() == e.storage_offset()
        and f.shape == e.shape
        and all(a == b for a, b, n in zip(f.stride(), e.stride(), f.shape) if n > 1)
    )


def param_table(params: GPHyperParams) -> tuple[torch.Tensor, bool]:
    """The (S, 3d + 2) float64 table of log GPHPs, and whether ``params``
    carried the sample axis. Where the fields are views of one packed table
    (``GPHyperParams.unpack``, as the engine holds its draws), that table
    itself, with no copy; otherwise ``params.pack()``."""
    ls = params.log_lengthscale
    batched = ls.ndim == 2
    d = ls.shape[-1]
    w = GPHyperParams.packed_size(d)
    S = ls.shape[0] if batched else 1
    base = ls.storage_offset()
    if ls.dtype == torch.float64 and ls.untyped_storage().nbytes() >= (base + S * w) * 8:
        table = ls.as_strided((S, w), (w, 1), base)
        expect = GPHyperParams.unpack(table if batched else table[0], d)
        if all(_same_view(f, e) for f, e in zip(params, expect)):
            return table, batched
    table = params.pack().to(torch.float64)
    return (table if batched else table[None]).contiguous(), batched


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


def matern52_rows(
    x_new: torch.Tensor,
    x_train: torch.Tensor,
    idx: int,
    size: int,
    params: GPHyperParams,
    *,
    warp: bool = True,
) -> torch.Tensor:
    """``gram_rows`` on the kernel: (R, size), or (S, R, size) for sampled
    parameters; float64 inputs and output, float32 gram."""
    table, batched = param_table(params)
    out = matern52_cross_kernel(
        x_new.contiguous(), x_train.contiguous(), table, idx, size, warp
    )
    return out if batched else out[0]


def matern52_operand(
    x: torch.Tensor,
    params: GPHyperParams,
    mask: torch.Tensor,
    jitter: float,
    *,
    warp: bool = True,
) -> torch.Tensor:
    """``gp.masked_operand`` of the float32 gram of x, in one launch: (n, n),
    or (S, n, n) for sampled parameters; float64."""
    table, batched = param_table(params)
    out = matern52_operand_kernel(x.contiguous(), table, mask, jitter, warp)
    return out if batched else out[0]
