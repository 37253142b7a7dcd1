"""The part of the JAX package's Mamba-1 block the port needs so far: the
depthwise causal convolution, which the RG-LRU block shares. The Mamba
block itself (falcon-mamba-7b) waits for its scan kernel (ROADMAP A12, B6).
"""

from __future__ import annotations

import torch

__all__ = ["_causal_conv"]


def _causal_conv(u: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, state=None):
    """Depthwise causal conv over time. u: (B,S,di), w: (dc,di).
    state: (B, dc-1, di) trailing context for decode; returns (out, new_state)."""
    dc = w.shape[0]
    if state is None:
        pad = torch.zeros((u.shape[0], dc - 1, u.shape[2]), dtype=u.dtype, device=u.device)
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)  # (B, S+dc-1, di)
    out = sum(
        full[:, i: i + u.shape[1], :] * w[i].to(u.dtype) for i in range(dc)
    ) + bias.to(u.dtype)
    new_state = full[:, -(dc - 1):, :] if dc > 1 else torch.zeros_like(pad)
    return out, new_state
