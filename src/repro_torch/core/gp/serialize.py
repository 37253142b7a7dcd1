"""Exact wire encoding of engine arrays (numpy byte images).

Arrays are shipped as little-endian raw bytes (base64) plus dtype and shape,
so a round trip is exact for every dtype: the byte image of a float64 is its
identity. The ``ObservationStore`` uses these for its fingerprint and its
``state_dict``; the encoding is the JAX package's, so a store blob written
by either package loads into the other.

Posterior (factor) serialization belongs to the multi-job service and waits
with it (ROADMAP queue A item 7).
"""

from __future__ import annotations

import base64
import hashlib
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["array_to_wire", "array_from_wire", "array_fingerprint"]


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
