"""Carry GP state across from the JAX package (or any numpy source).

The JAX package's arrays convert with ``np.asarray``; these functions turn
the resulting numpy arrays into the port's tensors on a device:

* ``params_from_numpy`` — packed GPHP draws (S, 3d+2) or (3d+2,) →
  ``GPHyperParams``;
* ``posterior_from_numpy`` — a dict of ``x_train``, ``mask``, ``chol``,
  ``alpha``, packed ``params`` and optionally ``chol_inv`` →
  ``GPPosterior``;
* ``posterior_to_numpy`` — the inverse, for comparing the two packages.

A JAX ``BOSuggester.state_dict()`` needs no conversion: the port's
``BOSuggester.load_state_dict`` takes it unchanged (the threefry key stays a
uint32 pair, the GPHP draws packed float64 lists).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.gp.gp import GPPosterior
from repro_torch.core.gp.params import GPHyperParams

__all__ = ["params_from_numpy", "posterior_from_numpy", "posterior_to_numpy"]


def params_from_numpy(
    packed, d: Optional[int] = None, device="cpu"
) -> GPHyperParams:
    """Packed log-space GPHPs → ``GPHyperParams`` of float64 tensors."""
    vec = torch.as_tensor(np.array(packed, dtype=np.float64)).to(device)
    if d is None:
        d = (vec.shape[-1] - 2) // 3
    if vec.shape[-1] != GPHyperParams.packed_size(d):
        raise ValueError(f"packed width {vec.shape[-1]} does not fit d={d}")
    return GPHyperParams.unpack(vec, d)


def posterior_from_numpy(blob: Mapping[str, Any], device="cpu") -> GPPosterior:
    """A factorized posterior from numpy arrays (see the module docstring)."""

    def f64(key):
        return torch.as_tensor(np.array(blob[key], dtype=np.float64)).to(device)

    x_train = f64("x_train")
    linv = blob.get("chol_inv")
    return GPPosterior(
        x_train=x_train,
        mask=torch.as_tensor(np.array(blob["mask"], dtype=bool)).to(device),
        chol=f64("chol"),
        alpha=f64("alpha"),
        params=params_from_numpy(blob["params"], x_train.shape[-1], device),
        chol_inv=None if linv is None else f64("chol_inv"),
    )


def posterior_to_numpy(post) -> Dict[str, Any]:
    """``x_train``, ``mask``, ``chol``, ``alpha``, packed ``params`` and
    ``chol_inv`` (or None) as numpy arrays — works on either package's
    posterior."""

    def host(t):
        if t is None:
            return None
        if isinstance(t, torch.Tensor):
            return t.detach().cpu().numpy()
        return np.asarray(t)

    return {
        "x_train": host(post.x_train),
        "mask": host(post.mask),
        "chol": host(post.chol),
        "alpha": host(post.alpha),
        "params": host(post.params.pack()),
        "chol_inv": host(post.chol_inv),
    }
