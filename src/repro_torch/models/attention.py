"""Grouped-query attention of the port: prefill forward and KV-cache decode.

Variants covered, as in the JAX package: GQA with any (num_heads,
num_kv_heads) incl. MHA and MQA; RoPE with a configurable theta, partial
rotary fraction and a separate local theta for sliding-window layers, or
no position embedding at all (``cfg.rope`` False: NoPE, granite 4.0-H) and
a configured softmax scale (``cfg.attn_scale``; the port's own options);
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

Training (``impl="torch"``, the JAX package's XLA route, which fuses the
composition) takes the hand-written flash-attention pair instead where a
call shows it can: gradients recorded (grad mode on, q requiring one) and
bf16 tensors on the card. The pair takes every head dim the forward kernel
takes (a multiple of 8, at most 256) and raises on any other, as the kernel
route does. The pair (``kernels/flash_attention/train.py``) is the
forward kernel with the row log-sum-exp and a deterministic backward in
three kernels; scores and softmax stay in f32 registers, and nothing of
size S² reaches device memory. Like the kernel route it takes positions
0…S−1, which ``Model.loss_fn`` passes. Everything else keeps the
composition: prefill and serving on ``impl="torch"``, decode, the CPU, f32
compute, any call without a gradient, and fake tensors (the dry-run traces
the composition, whose operations it can count, and no kernel runs on a
tensor without storage). The counters
``attn.train.kernel`` and ``attn.train.plain`` count the grad-recording
calls the pair took and left, while telemetry records and no graph is
being captured.

Decode is the plain composition in both (the JAX model uses no kernel
there either).

On a mesh q, k, v and the output are constrained where the JAX package
constrains them. The plain composition runs on the DTensors, kept right by
DTensor's own redistributions. The kernel takes plain tensors, so it runs
on each rank's shards with declared placements — sharded over batch and
heads, replicated over the sequence (a sequence-sharded interior is
gathered first) — and, where the query heads are sharded and the KV heads
are not (kv_heads does not divide the model axis), on this rank's slice of
the KV heads: the GQA index is global, and the local call must see the KV
heads its query heads read.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.core import telemetry
from repro_torch.distributed.sharding import PartitionSpec
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.train import FlashAttentionTrain
from repro_torch.models.common import NO_MESH, ParamModule, ShardCtx, apply_rope, rms_norm, rope_freqs

__all__ = [
    "attention_params", "attention_fwd", "attention_decode", "init_kv_cache", "slot_valid",
]

_NEG_INF = -2.0e38


def attention_params(cfg) -> ParamModule:
    d, hq, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = ParamModule()
    p.declare("wq", (d, hq, dh), scale=d**-0.5, logical_axes=("fsdp", "heads", "head_dim"))
    p.declare("wk", (d, hkv, dh), scale=d**-0.5, logical_axes=("fsdp", "kv_heads", "head_dim"))
    p.declare("wv", (d, hkv, dh), scale=d**-0.5, logical_axes=("fsdp", "kv_heads", "head_dim"))
    p.declare("wo", (hq, dh, d), scale=(hq * dh) ** -0.5,
              logical_axes=("heads", "head_dim", "fsdp"))
    if cfg.qkv_bias:
        p.declare("bq", (hq, dh), init="zeros", logical_axes=("heads", "head_dim"))
        p.declare("bk", (hkv, dh), init="zeros", logical_axes=("kv_heads", "head_dim"))
        p.declare("bv", (hkv, dh), init="zeros", logical_axes=("kv_heads", "head_dim"))
    if cfg.qk_norm:
        p.declare("q_norm", (dh,), init="zeros", logical_axes=(None,))
        p.declare("k_norm", (dh,), init="zeros", logical_axes=(None,))
    return p


def _heads(x: torch.Tensor, w: torch.Tensor, ctx: ShardCtx = NO_MESH,
           axis: str = "heads") -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product. On a mesh it runs on
    each rank's shards — the weight's FSDP dim gathered, its heads (``axis``)
    sharded as they divide — so that neither the product nor its gradient
    is split along the flattened h·k columns where h does not divide."""
    d, h, k = w.shape

    def local(x_, w_):
        h_ = w_.shape[1]
        return (x_ @ w_.to(x_.dtype).reshape(d, h_ * k)).reshape(*x_.shape[:-1], h_, k)

    out_shape = tuple(x.shape[:-1]) + (h, k)
    if not ctx.active:
        return local(x, w)
    out = ctx.spec(("batch", "attn_seq", axis, None), out_shape)
    out = PartitionSpec(*(tuple(out) + (None,) * (4 - len(out))))
    return ctx.local_call(local, [(x, PartitionSpec(*out[:2])), (w, PartitionSpec(None, out[2]))],
                          [(out, out_shape)])


def _project_qkv(x, p, cfg, positions, theta, ctx: ShardCtx = NO_MESH):
    """x: (B,S,D) -> q (B,S,Hq,Dh), k/v (B,S,Hkv,Dh), normed and, unless
    ``cfg.rope`` is False, roped."""
    cdt = x.dtype
    q = _heads(x, p.wq, ctx)
    k, v = _heads(x, p.wk, ctx, "kv_heads"), _heads(x, p.wv, ctx, "kv_heads")
    if cfg.qkv_bias:
        q = q + p.bq.to(cdt)
        k = k + p.bk.to(cdt)
        v = v + p.bv.to(cdt)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    if cfg.rope:
        inv_freq = rope_freqs(cfg.head_dim, theta, cfg.rope_fraction, device=x.device)
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
    return q, k, v


def _gqa_scores(q_chunk, k, mask, cfg):
    """Masked, scaled (and soft-capped) f32 scores (B, Hkv, G, C, S) of
    q_chunk (B,C,Hq,Dh) against k (B,S,Hkv,Dh); mask (B,C,S) bool. The head
    counts are the tensors' own (a rank's shards on a mesh)."""
    hkv = k.shape[2]
    b, c, hq, dh = q_chunk.shape
    qg = q_chunk.reshape(b, c, hkv, hq // hkv, dh)
    scores = torch.einsum("bchgd,bshd->bhgcs", qg, k).float()
    scores = scores * (cfg.attn_scale or dh**-0.5)
    if cfg.attn_softcap > 0:
        scores = cfg.attn_softcap * torch.tanh(scores / cfg.attn_softcap)
    return torch.where(mask[:, None, None, :, :], scores, _NEG_INF)


def _gqa_scores_to_out(q_chunk, k, v, mask, cfg):
    """q_chunk: (B,C,Hq,Dh); k/v: (B,S,Hkv,Dh); mask: (B,C,S) bool."""
    b, c, hq, dh = q_chunk.shape
    probs = torch.softmax(_gqa_scores(q_chunk, k, mask, cfg), dim=-1).to(q_chunk.dtype)
    out = torch.einsum("bhgcs,bshd->bchgd", probs, v)
    return out.reshape(b, c, hq, dh)


def _out_proj(out: torch.Tensor, wo: torch.Tensor, cdt,
              ctx: ShardCtx = NO_MESH) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matrix product; on a mesh on each
    rank's heads, a partial sum over the heads' mesh axes."""
    h, k, d = wo.shape

    def local(o_, w_):
        h_ = w_.shape[0]
        return o_.reshape(*o_.shape[:-2], h_ * k) @ w_.to(cdt).reshape(h_ * k, d)

    if not ctx.active:
        return local(out, wo)
    o = ctx.spec(("batch", "attn_seq", "heads", None), out.shape)
    o = PartitionSpec(*(tuple(o) + (None,) * (3 - len(o))))
    return ctx.local_call(local, [(out, o), (wo, PartitionSpec(o[2]))],
                          [(PartitionSpec(*o[:2]), tuple(out.shape[:-2]) + (d,),
                            ctx.mesh_axes(o[2]))])


def _local_kv(q, k, v, hq: int, hkv: int, q_entry, ctx: ShardCtx):
    """The KV heads this rank's query heads read: all of them when both are
    sharded alike or neither is; this rank's slice when only the query heads
    are sharded. Refuses a split the group size does not align with."""
    hq_l, hkv_l = q.shape[2], k.shape[2]
    if hq_l == hq or hkv_l < hkv:
        return k, v
    g = hq // hkv
    h0 = ctx.shard_index(q_entry) * hq_l
    if hq_l % g == 0:
        lo, n = h0 // g, hq_l // g
    elif g % hq_l == 0:
        lo, n = h0 // g, 1
    else:
        raise ValueError(f"attention: {hq_l} local query heads do not align with groups of {g}")
    return k[:, :, lo:lo + n], v[:, :, lo:lo + n]


def _train_route(q: torch.Tensor) -> bool:
    """Whether a grad-recording call runs the flash-attention pair: bf16 on
    the card, and not a fake tensor; counted while telemetry records and no
    graph is being captured."""
    take = q.is_cuda and q.dtype == torch.bfloat16 and not is_fake(q)
    if telemetry.recording(q.device):
        telemetry.count("attn.train.kernel" if take else "attn.train.plain")
    return take


def _attend(q, k, v, positions, cfg, window: int, impl: str, q_chunk: int,
            ctx: ShardCtx) -> torch.Tensor:
    """Causal (windowed) attention of (B,S,H,Dh) q/k/v: the flash-attention
    kernel, training's flash-attention pair or the plain composition, on
    local shards under a mesh (see the module docstring)."""
    if impl not in ("kernel", "torch"):
        raise ValueError(f"unknown attention impl {impl!r} (kernel or torch)")
    q_axes, kv_axes = ("batch", None, "heads", None), ("batch", None, "kv_heads", None)
    hq, hkv = q.shape[2], k.shape[2]
    spec = ctx.spec(q_axes, q.shape) if ctx.active else ()
    q_entry = spec[2] if len(spec) > 2 else None

    if impl == "kernel" and cfg.attn_scale:
        raise NotImplementedError("the flash-attention kernel scales by head_dim^-0.5 only")

    def local(ql, kl, vl, pos):
        kl, vl = _local_kv(ql, kl, vl, hq, hkv, q_entry, ctx)
        if impl == "kernel":
            return flash_attention_kernel(ql.contiguous(), kl.contiguous(), vl.contiguous(),
                                          window, cfg.attn_softcap)
        if torch.is_grad_enabled() and ql.requires_grad and _train_route(ql):
            return FlashAttentionTrain.apply(ql.contiguous(), kl.contiguous(), vl.contiguous(),
                                             window, float(cfg.attn_softcap),
                                             cfg.attn_scale or ql.shape[-1] ** -0.5)
        chunks = []
        for q_i, pos_i in zip(ql.split(q_chunk, dim=1), pos.split(q_chunk, dim=1)):
            mask = pos_i[:, :, None] >= pos[:, None, :]  # causal
            if window > 0:
                mask &= pos_i[:, :, None] - pos[:, None, :] < window
            chunks.append(_gqa_scores_to_out(q_i, kl, vl, mask, cfg))
        return torch.cat(chunks, dim=1)

    return ctx.local_call(local, [(q, q_axes), (k, kv_axes), (v, kv_axes),
                                  (positions, ("batch", None))], [(q_axes, q.shape)])


def attention_fwd(
    x: torch.Tensor,  # (B, S, D)
    p: ParamModule,
    cfg,
    positions: torch.Tensor,  # (B, S)
    window: int = 0,  # 0 = global causal
    theta: Optional[float] = None,
    impl: str = "kernel",
    q_chunk: int = 1024,
    ctx: ShardCtx = NO_MESH,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Prefill attention. Returns (out (B,S,D), (k, v) for caching). The
    kernel takes positions 0..S−1, which is what a prefill passes."""
    theta = theta or cfg.rope_theta
    q, k, v = _project_qkv(x, p, cfg, positions, theta, ctx)
    q = ctx.constrain(q, ("batch", "attn_seq", "heads", None))
    k = ctx.constrain(k, ("batch", "attn_seq", "kv_heads", None))
    v = ctx.constrain(v, ("batch", "attn_seq", "kv_heads", None))
    out = _attend(q, k, v, positions, cfg, window, impl, q_chunk, ctx)
    out = ctx.constrain(out, ("batch", "attn_seq", "heads", None))
    y = ctx.constrain(_out_proj(out, p.wo, x.dtype, ctx), ("batch", "seq", "embed"))
    return y, (k, v)


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
    ctx: ShardCtx = NO_MESH,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One decode step. The cache stores *post-RoPE* keys and is updated in
    place (the JAX package returns a new one). For window>0 the cache is a
    ring buffer of size C (slot = position mod C). On a mesh the slot is
    written on each rank's shard of the cache: the rank whose sequence
    shard holds it, where the cache is sharded over its sequence."""
    theta = theta or cfg.rope_theta
    k_cache, v_cache = cache
    b, c = k_cache.shape[:2]
    positions = torch.full((b, 1), t, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(x, p, cfg, positions, theta, ctx)

    slot = t % max(c, 1) if window > 0 else t
    slot = min(max(slot, 0), c - 1)  # dynamic_update_slice clamps its start
    _write_slot(k_cache, k_new, slot, ctx)
    _write_slot(v_cache, v_new, slot, ctx)

    valid = slot_valid(c, t, window, x.device)
    if not ctx.active:
        mask = valid[None, None, :].expand(b, 1, c)
        out = _gqa_scores_to_out(q, k_cache.to(q.dtype), v_cache.to(q.dtype), mask, cfg)
    else:
        out = _decode_attend_sharded(q, k_cache, v_cache, valid, cfg, ctx)
    return ctx.constrain(_out_proj(out, p.wo, x.dtype, ctx), ("batch", None, "embed")), (k_cache, v_cache)


def _decode_attend_sharded(q, k_cache, v_cache, valid, cfg, ctx: ShardCtx):
    """Decode attention of q (B,1,Hq,Dh) over caches placed by
    ("batch", "cache_seq", "kv_heads", None), on each rank's shards. With
    the sequence whole on every rank it is the plain composition on the
    shards. With the sequence sharded, each rank takes every query head
    over its slots and returns its softmax statistics (max, sum and the
    unnormalised output, f32), which are combined across the shards."""
    cache_axes = ("batch", "cache_seq", "kv_heads", None)
    c_spec = ctx.spec(cache_axes, k_cache.shape)
    seq_entry = c_spec[1] if len(c_spec) > 1 else None
    hq, hkv = q.shape[2], k_cache.shape[2]
    b, _, _, dh = q.shape
    q_axes = ("batch", None, "heads", None)
    if seq_entry is None:
        q_spec = ctx.spec(q_axes, q.shape)
        q_entry = q_spec[2] if len(q_spec) > 2 else None

        def local(ql, kl, vl):
            kl, vl = _local_kv(ql, kl, vl, hq, hkv, q_entry, ctx)
            mask = valid[None, None, :].expand(ql.shape[0], 1, valid.shape[0])
            return _gqa_scores_to_out(ql, kl.to(ql.dtype), vl.to(ql.dtype), mask, cfg)

        return ctx.local_call(local, [(q, q_axes), (k_cache, cache_axes), (v_cache, cache_axes)],
                              [(q_axes, q.shape)])
    q_axes = ("batch", None, None, None)  # every head meets every slot shard
    n = len(valid) // k_cache.to_local().shape[1]

    def local(ql, kl, vl):
        if kl.shape[2] != hkv:
            raise ValueError("decode attention: a cache sharded over both its "
                             "sequence and its KV heads is not supported")
        rows = kl.shape[1]
        s0 = ctx.shard_index(seq_entry) * rows
        mask = valid[s0:s0 + rows][None, None, :].expand(ql.shape[0], 1, rows)
        scores = _gqa_scores(ql, kl.to(ql.dtype), mask, cfg)  # (B, Hkv, G, 1, rows)
        m = scores.amax(-1, keepdim=True)
        e = torch.exp(scores - m)
        o = torch.einsum("bhgcs,bshd->bchgd", e, vl.float())  # (B, 1, Hkv, G, Dh)
        bl = ql.shape[0]
        return (m.reshape(1, bl, hq), e.sum(-1).reshape(1, bl, hq),
                o.reshape(1, bl, hq, dh))

    stat = ("cache_seq", "batch", None)
    m, l, o = ctx.local_call(
        local, [(q, q_axes), (k_cache, cache_axes), (v_cache, cache_axes)],
        [(stat, (n, b, hq)), (stat, (n, b, hq)), (stat + (None,), (n, b, hq, dh))])
    top = m.amax(0, keepdim=True)
    w = torch.exp(m - top)
    out = (o * w[..., None]).sum(0) / (l * w).sum(0)[..., None]  # (B, Hq, Dh)
    return out[:, None].to(q.dtype)


def _write_slot(cache: torch.Tensor, new: torch.Tensor, slot: int, ctx: ShardCtx) -> None:
    """cache[:, slot] = new[:, 0], in place; on a mesh on each rank's shard
    of a cache constrained to ("batch", "cache_seq", "kv_heads", None)."""
    if not ctx.active:
        cache[:, slot] = new[:, 0].to(cache.dtype)
        return
    axes = ("batch", "cache_seq", "kv_heads", None)
    spec = ctx.spec(axes, cache.shape)
    seq_entry = spec[1] if len(spec) > 1 else None
    from torch.distributed.tensor import Replicate, Shard

    # the cache's own placements, its sequence dim whole
    placements = [Replicate() if pl == Shard(1) else pl for pl in cache.placements]
    new = ctx.constrain(new, ("batch", None, "kv_heads", None))
    new = new.to(cache.dtype).redistribute(ctx.mesh, placements)
    local_cache, local_new = cache.to_local(), new.to_local()
    rows = local_cache.shape[1]
    s0 = ctx.shard_index(seq_entry) * rows
    if s0 <= slot < s0 + rows:
        local_cache[:, slot - s0] = local_new[:, 0]
