"""Exact wire encoding of engine arrays (numpy byte images).

Arrays are shipped as little-endian raw bytes (base64) plus dtype and shape,
so a round trip is exact for every dtype: the byte image of a float64 is its
identity. The ``ObservationStore`` uses these for its fingerprint and its
``state_dict``, the multi-job service for engine snapshots; the encoding is
the JAX package's, so a blob written by either package loads into the other.

Factor blocks (the O(S·n²) Cholesky / L⁻¹ / alpha tensors of a
``GPPosterior``) are optional in a snapshot: they are a pure function of the
GPHP draws and the observation rows, so a restoring service rebuilds them
locally. ``posterior_to_wire`` / ``posterior_from_wire`` ship them when
that is worth it; the tensors cross as host byte images and land on the
device the caller names.
"""

from __future__ import annotations

import base64
import hashlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.gp.gp import GPPosterior
from repro_torch.core.gp.params import GPHyperParams

__all__ = [
    "array_to_wire",
    "array_from_wire",
    "array_fingerprint",
    "posterior_to_wire",
    "posterior_from_wire",
]


def array_to_wire(arr: Optional[np.ndarray]) -> Optional[Dict[str, Any]]:
    """Encode an array as ``{"dtype", "shape", "data"}`` with base64 raw
    little-endian bytes. Returns None for None (optional fields)."""
    if arr is None:
        return None
    a = np.ascontiguousarray(np.asarray(arr))
    le = a.astype(a.dtype.newbyteorder("<"), copy=False)
    return {
        "dtype": le.dtype.str,
        "shape": list(a.shape),
        "data": base64.b64encode(le.tobytes()).decode("ascii"),
    }


def array_from_wire(blob: Optional[Dict[str, Any]]) -> Optional[np.ndarray]:
    """Inverse of ``array_to_wire``. Returns None for None."""
    if blob is None:
        return None
    raw = base64.b64decode(blob["data"])
    a = np.frombuffer(raw, dtype=np.dtype(blob["dtype"]))
    return a.reshape(tuple(blob["shape"])).copy()


def array_fingerprint(arr: Optional[np.ndarray]) -> Optional[str]:
    """Short content hash of an array's byte image."""
    if arr is None:
        return None
    a = np.ascontiguousarray(np.asarray(arr))
    le = a.astype(a.dtype.newbyteorder("<"), copy=False)
    return hashlib.sha256(le.tobytes()).hexdigest()[:16]


def _host(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.detach().cpu().numpy()


def posterior_to_wire(post: GPPosterior) -> Dict[str, Any]:
    """Serialize a factorized ``GPPosterior`` (optionally batched over S MCMC
    samples). GPHPs travel in packed form; ``chol_inv`` is included iff
    cached."""
    return {
        "x_train": array_to_wire(_host(post.x_train)),
        "mask": array_to_wire(_host(post.mask)),
        "chol": array_to_wire(_host(post.chol)),
        "alpha": array_to_wire(_host(post.alpha)),
        "params_packed": array_to_wire(_host(post.params.pack())),
        "chol_inv": array_to_wire(_host(post.chol_inv)),
    }


def posterior_from_wire(blob: Dict[str, Any], device=None) -> GPPosterior:
    """Inverse of ``posterior_to_wire``; the tensors land on ``device``
    (``None``: the CUDA card) ready for the incremental-update path."""
    dev = resolve_device(device)

    def tensor(name):
        arr = array_from_wire(blob.get(name))
        return None if arr is None else torch.as_tensor(arr).to(dev)

    x_train = tensor("x_train")
    return GPPosterior(
        x_train=x_train,
        mask=tensor("mask"),
        chol=tensor("chol"),
        alpha=tensor("alpha"),
        params=GPHyperParams.unpack(tensor("params_packed"), x_train.shape[-1]),
        chol_inv=tensor("chol_inv"),
    )
