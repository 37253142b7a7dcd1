"""Plain PyTorch version of the flash-decode kernel.

The same function as ``csrc/decode_attention.cu``: the masked softmax of
the JAX package's oracle (``decode_attention/ref.py``), with the query heads
taken in groups over their KV head (nothing expanded), scores and softmax
in float32, output in the inputs' dtype — except for a row with no valid
slot, which gives 0 as the TPU kernel does (``decode_attention_pallas``
keeps p = 0 and l = 0 there), where the oracle's plain softmax gives the
mean of V (ROADMAP C9). It forms the whole (G, C) score matrix — no tiling,
no online softmax — so the kernel sums in another order and agrees only to
rounding.
"""

from __future__ import annotations

import torch

__all__ = ["decode_attention_plain"]


def decode_attention_plain(q, k_cache, v_cache, valid, softcap: float = 0.0) -> torch.Tensor:
    """q (B, Hq, Dh), k/v caches (B, C, Hkv, Dh), valid (B, C) bool →
    (B, Hq, Dh)."""
    b, hq, dh = q.shape
    hkv = k_cache.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, dh)
    scores = torch.einsum("bhgd,bchd->bhgc", qg, k_cache.float()) * dh**-0.5
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    live = valid[:, None, None, :]
    m = scores.masked_fill(~live, -torch.inf).amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)  # a row with no live slot
    p = torch.where(live, torch.exp(scores - m), torch.zeros_like(scores))
    out = torch.einsum("bhgc,bchd->bhgd", p, v_cache.float())
    out = out / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, hq, dh).to(q.dtype)
