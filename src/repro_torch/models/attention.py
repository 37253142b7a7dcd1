"""Grouped-query attention of the port: prefill forward and KV-cache decode.

Variants covered, as in the JAX package: GQA with any (num_heads,
num_kv_heads) incl. MHA and MQA; RoPE with a configurable theta, partial
rotary fraction and a separate local theta for sliding-window layers;
sliding-window attention ("swa" blocks) with ring-buffer decode caches;
attention logit soft-capping, QK RMS-norm and optional QKV biases.

Implementations of the prefill forward:
  * ``impl="kernel"`` — the hand-written CUDA flash-attention kernel
    (``repro_torch.kernels.flash_attention``), the counterpart of the JAX
    package's ``impl="pallas"``; on a CPU tensor its wrapper runs the
    kernel's plain version;
  * ``impl="torch"`` — the plain composition, the counterpart of
    ``impl="xla"``: queries in chunks of ``q_chunk`` against all keys, with
    probabilities cast to the compute dtype before P·V.

Decode is the plain composition in both (the JAX model uses no kernel
there either).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.models.common import ParamModule, apply_rope, rms_norm, rope_freqs

__all__ = [
    "attention_params", "attention_fwd", "attention_decode", "init_kv_cache", "slot_valid",
]

_NEG_INF = -2.0e38


def attention_params(cfg) -> ParamModule:
    d, hq, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = ParamModule()
    p.declare("wq", (d, hq, dh), scale=d**-0.5)
    p.declare("wk", (d, hkv, dh), scale=d**-0.5)
    p.declare("wv", (d, hkv, dh), scale=d**-0.5)
    p.declare("wo", (hq, dh, d), scale=(hq * dh) ** -0.5)
    if cfg.qkv_bias:
        p.declare("bq", (hq, dh), init="zeros")
        p.declare("bk", (hkv, dh), init="zeros")
        p.declare("bv", (hkv, dh), init="zeros")
    if cfg.qk_norm:
        p.declare("q_norm", (dh,), init="zeros")
        p.declare("k_norm", (dh,), init="zeros")
    return p


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _project_qkv(x, p, cfg, positions, theta):
    """x: (B,S,D) -> q (B,S,Hq,Dh), k/v (B,S,Hkv,Dh), roped + normed."""
    cdt = x.dtype
    q, k, v = _heads(x, p.wq), _heads(x, p.wk), _heads(x, p.wv)
    if cfg.qkv_bias:
        q = q + p.bq.to(cdt)
        k = k + p.bk.to(cdt)
        v = v + p.bv.to(cdt)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    inv_freq = rope_freqs(cfg.head_dim, theta, cfg.rope_fraction, device=x.device)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)
    return q, k, v


def _gqa_scores_to_out(q_chunk, k, v, mask, cfg):
    """q_chunk: (B,C,Hq,Dh); k/v: (B,S,Hkv,Dh); mask: (B,C,S) bool."""
    hkv, g = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    b, c, _, dh = q_chunk.shape
    qg = q_chunk.reshape(b, c, hkv, g, dh)
    scores = torch.einsum("bchgd,bshd->bhgcs", qg, k).float()
    scores = scores * (dh**-0.5)
    if cfg.attn_softcap > 0:
        scores = cfg.attn_softcap * torch.tanh(scores / cfg.attn_softcap)
    scores = torch.where(mask[:, None, None, :, :], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q_chunk.dtype)
    out = torch.einsum("bhgcs,bshd->bchgd", probs, v)
    return out.reshape(b, c, cfg.num_heads, dh)


def _out_proj(out: torch.Tensor, wo: torch.Tensor, cdt) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matrix product."""
    h, k, d = wo.shape
    return out.reshape(*out.shape[:-2], h * k) @ wo.to(cdt).reshape(h * k, d)


def attention_fwd(
    x: torch.Tensor,  # (B, S, D)
    p: ParamModule,
    cfg,
    positions: torch.Tensor,  # (B, S)
    window: int = 0,  # 0 = global causal
    theta: Optional[float] = None,
    impl: str = "kernel",
    q_chunk: int = 1024,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Prefill attention. Returns (out (B,S,D), (k, v) for caching). The
    kernel takes positions 0..S−1, which is what a prefill passes."""
    theta = theta or cfg.rope_theta
    q, k, v = _project_qkv(x, p, cfg, positions, theta)
    if impl == "kernel":
        out = flash_attention_kernel(q, k, v, window, cfg.attn_softcap)
    elif impl == "torch":
        chunks = []
        for q_i, pos_i in zip(q.split(q_chunk, dim=1), positions.split(q_chunk, dim=1)):
            mask = pos_i[:, :, None] >= positions[:, None, :]  # causal
            if window > 0:
                mask &= pos_i[:, :, None] - positions[:, None, :] < window
            chunks.append(_gqa_scores_to_out(q_i, k, v, mask, cfg))
        out = torch.cat(chunks, dim=1)
    else:
        raise ValueError(f"unknown attention impl {impl!r} (kernel or torch)")
    return _out_proj(out, p.wo, x.dtype), (k, v)


# ---------------------------------------------------------------------------
# Decode with KV cache
# ---------------------------------------------------------------------------
def init_kv_cache(cfg, batch: int, cache_len: int, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def slot_valid(c: int, t: int, window: int, device) -> torch.Tensor:
    """(C,) bool: which cache slots hold a visible key at time t. A ring
    (window > 0): slot s holds position p = t − ((t − s) mod C), valid when
    p ≥ max(0, t − window + 1); else slot s holds position s, valid when
    s ≤ t."""
    idx = torch.arange(c, device=device)
    if window > 0:
        pos_of_slot = t - torch.remainder(t - idx, c)
        return (pos_of_slot >= max(0, t - window + 1)) & (pos_of_slot >= 0)
    return idx <= t


def attention_decode(
    x: torch.Tensor,  # (B, 1, D) current-token activations
    p: ParamModule,
    cfg,
    cache: Tuple[torch.Tensor, torch.Tensor],  # (B, C, Hkv, Dh) ×2
    t: int,  # current absolute position
    window: int = 0,  # 0 = full cache; >0 = ring buffer of size C
    theta: Optional[float] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One decode step. The cache stores *post-RoPE* keys and is updated in
    place (the JAX package returns a new one). For window>0 the cache is a
    ring buffer of size C (slot = position mod C)."""
    theta = theta or cfg.rope_theta
    k_cache, v_cache = cache
    b, c = k_cache.shape[:2]
    positions = torch.full((b, 1), t, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(x, p, cfg, positions, theta)

    slot = t % max(c, 1) if window > 0 else t
    slot = min(max(slot, 0), c - 1)  # dynamic_update_slice clamps its start
    k_cache[:, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v_new[:, 0].to(v_cache.dtype)

    mask = slot_valid(c, t, window, x.device)[None, None, :].expand(b, 1, c)

    out = _gqa_scores_to_out(q, k_cache.to(q.dtype), v_cache.to(q.dtype), mask, cfg)
    return _out_proj(out, p.wo, x.dtype), (k_cache, v_cache)
