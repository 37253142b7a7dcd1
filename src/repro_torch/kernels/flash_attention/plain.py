"""Plain PyTorch versions of the flash-attention kernels.

``flash_attention_plain`` is the same function as ``csrc/flash_attention.cu``:
the masked softmax of the JAX package's oracle (``flash_attention/ref.py``),
with the query heads taken in groups over their KV head (GQA by groups,
nothing expanded), scores and softmax in float32, output in the inputs'
dtype; with ``lse`` it also returns the row log-sum-exp the training
forward writes. ``flash_attention_bwd_plain`` is ``csrc/flash_attention_bwd.cu``:
the explicit gradient formulas of that attention in float32. Both form the
whole (S, S) score matrix per head — no tiling, no online softmax — so the
kernels sum in another order and agree only to rounding.
"""

from __future__ import annotations

import torch

__all__ = ["flash_attention_plain", "flash_attention_bwd_plain", "band_mask"]

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


def _scores(q, k, window, softcap, scale):
    """f32 scores (B, Hkv, G, S, S), scaled, soft-capped and masked, and
    the derivative of the cap (1 − tanh², or None without one)."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, s, hkv, hq // hkv, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    dcap = None
    if softcap > 0:
        t = torch.tanh(scores / softcap)
        scores, dcap = softcap * t, 1.0 - t * t
    return scores.masked_fill(~band_mask(s, window, q.device), _NEG_INF), dcap


def flash_attention_plain(q, k, v, window: int = 0, softcap: float = 0.0,
                          scale: float | None = None, lse: bool = False):
    """Causal attention: q (B, S, Hq, Dh), k/v (B, S, Hkv, Dh) → (B, S, Hq,
    Dh), scores scaled by ``scale`` (Dh^-1/2 when None); with ``lse`` also
    the row log-sum-exp of the scores, f32 (B, Hq, S)."""
    b, s, hq, dh = q.shape
    scores, _ = _scores(q, k, window, softcap, dh**-0.5 if scale is None else scale)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    out = out.reshape(b, s, hq, dh).to(q.dtype).contiguous()
    if not lse:
        return out
    return out, torch.logsumexp(scores, dim=-1).reshape(b, hq, s)


def flash_attention_bwd_plain(q, k, v, o, lse, do, window: int = 0, softcap: float = 0.0,
                              scale: float | None = None):
    """(dq, dk, dv) in the inputs' dtype: P = exp(scores − lse), D =
    rowsum(do ∘ o), dV = Σ_g Pᵀ·dO, dS = P ∘ (dO·Vᵀ − D) · (1 − tanh²),
    dQ = dS·K·scale, dK = Σ_g dSᵀ·Q·scale — in float32."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = dh**-0.5 if scale is None else scale
    scores, dcap = _scores(q, k, window, softcap, scale)
    probs = torch.exp(scores - lse.float().reshape(b, hkv, g, s, 1))
    probs = probs.masked_fill(~band_mask(s, window, q.device), 0.0)
    dog = do.float().reshape(b, s, hkv, g, dh)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", probs, dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    delta = (do.float() * o.float()).sum(-1).reshape(b, s, hkv, g).permute(0, 2, 3, 1)
    ds = probs * (dp - delta[..., None])
    if dcap is not None:
        ds = ds * dcap
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, q.float().reshape(b, s, hkv, g, dh)) * scale
    return dq.reshape(b, s, hq, dh).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
