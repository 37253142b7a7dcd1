"""Plain PyTorch version of the flash-attention kernel.

The same function as ``csrc/flash_attention.cu``: the masked softmax of the
JAX package's oracle (``flash_attention/ref.py``), with the query heads taken
in groups over their KV head (GQA by groups, nothing expanded), scores and
softmax in float32, output in the inputs' dtype. It forms the whole (S, S)
score matrix per head — no tiling, no online softmax — so the kernel sums in
another order and agrees only to rounding.
"""

from __future__ import annotations

import torch

__all__ = ["flash_attention_plain", "band_mask"]

_NEG_INF = -2.0e38  # the oracle's mask value


def band_mask(s: int, window: int, device) -> torch.Tensor:
    """(S, S) bool: key j is visible from query i — j ≤ i, and i − j <
    window when ``window`` > 0."""
    pos = torch.arange(s, device=device)
    diff = pos[:, None] - pos[None, :]
    mask = diff >= 0
    if window > 0:
        mask &= diff < window
    return mask


def flash_attention_plain(q, k, v, window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Causal attention: q (B, S, Hq, Dh), k/v (B, S, Hkv, Dh) → (B, S, Hq, Dh)."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, s, hkv, hq // hkv, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * dh**-0.5
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    scores = scores.masked_fill(~band_mask(s, window, q.device), _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, s, hq, dh).to(q.dtype)
