"""Feed-forward blocks of the port: dense (SwiGLU / GELU / squared-ReLU) and
MoE.

MoE follows the JAX package's capacity-based formulation (GShard/Switch
style): tokens are routed top-k, each (token, choice) pair takes a slot
within its expert's capacity C = ceil(T·k/E·cf) by an exclusive count over
the pairs in token-major, choice-minor order, the experts run as batched
matrix products over an (E, C, D) buffer, and the outputs are combined with
the renormalized router probabilities. A pair past its expert's capacity is
dropped (the residual path carries the token).

The JAX package scatter-adds the pairs into the buffer and scatter-adds the
weighted outputs back per token. The port moves the same values with
writes that never share an index, so that forward and backward are
deterministic on the card and no accumulation serializes on a repeated
index:

* dispatch — a token's rows are repeated k times with ``expand`` (whose
  gradient is a sum) and each pair is written to its slot; the kept pairs'
  (expert, slot) are unique, and a dropped pair goes to a row of its own
  past the slots, which the experts never read;
* combine — each slot's output is written back to its pair's row (an empty
  slot to a row of its own past the pairs), so a dropped pair's row stays
  zero; a token's k pairs are consecutive, so the scatter-add over
  ``repeat(arange(T), k)`` is a sum over the k axis.

The load-balancing auxiliary loss follows Switch Transformer:
aux = E · Σ_e f_e·P_e (f_e = fraction of tokens whose top-1 is e, carrying
no gradient; P_e = mean router probability of e), times ``aux_loss_weight``.

The chip's share of an expert-parallel layer (``MoESettings.num_held``):
the layer holds the experts first_held … first_held + num_held − 1 only.
The router scores all E experts and routing, slots and the aux loss are as
above over all of them; a pair routed to an expert held elsewhere is left
out here (its part of the result is the other chips'), so the layer returns
this chip's part. Nothing stands in for the absent chips. A shared expert
(``MoESettings.d_shared``, granite 4.0-H) is a SwiGLU FFN that every token
passes through beside the routed ones; its output is added to theirs.

On a mesh the tokens are laid out as W rows of Tl (W = 1 for the global
dispatch, the batch-sharding ways for ``dispatch="local"``). Routing,
dispatch and combine are index work on a row and run on each rank's rows
(``ShardCtx.local_call``); with W = 1 the row is the whole batch, gathered
on every rank, as the global formulation needs every token's place in the
count. The (E, W·C, D) buffer is sharded over the expert axis and the
expert products run on the DTensors.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import telemetry
from repro_torch.models.common import NO_MESH, ParamModule, ShardCtx

__all__ = ["mlp_params", "mlp_fwd", "moe_params", "moe_fwd"]


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------
def mlp_params(cfg) -> ParamModule:
    d, f = cfg.d_model, cfg.d_ff
    p = ParamModule()
    p.declare("w1", (d, f), scale=d**-0.5, logical_axes=("fsdp", "ffn"))
    p.declare("w2", (f, d), scale=f**-0.5, logical_axes=("ffn", "fsdp"))
    if cfg.mlp == "swiglu":
        p.declare("w3", (d, f), scale=d**-0.5, logical_axes=("fsdp", "ffn"))
    return p


def mlp_fwd(x: torch.Tensor, p: ParamModule, cfg, ctx: ShardCtx = NO_MESH) -> torch.Tensor:
    cdt = x.dtype
    h = ctx.constrain(x @ p.w1.to(cdt), ("batch", "attn_seq", "ffn"))
    if cfg.mlp == "swiglu":
        h = F.silu(h) * (x @ p.w3.to(cdt))
    elif cfg.mlp == "gelu":
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    elif cfg.mlp == "relu2":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(f"unknown mlp kind {cfg.mlp!r}")
    return ctx.constrain(h @ p.w2.to(cdt), ("batch", "seq", "embed"))


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------
def moe_params(cfg) -> ParamModule:
    d, e, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_expert
    held = cfg.moe.num_held or e
    p = ParamModule()
    p.declare("router", (d, e), scale=d**-0.5, logical_axes=("fsdp", None))
    p.declare("w1", (held, d, f), scale=d**-0.5,
              logical_axes=("experts", "fsdp", "expert_ffn"))
    p.declare("w2", (held, f, d), scale=f**-0.5,
              logical_axes=("experts", "expert_ffn", "fsdp"))
    if cfg.mlp == "swiglu":
        p.declare("w3", (held, d, f), scale=d**-0.5,
                  logical_axes=("experts", "fsdp", "expert_ffn"))
    if cfg.moe.d_shared:
        fs = cfg.moe.d_shared
        p.declare("shared_w1", (d, fs), scale=d**-0.5, logical_axes=("fsdp", "ffn"))
        p.declare("shared_w3", (d, fs), scale=d**-0.5, logical_axes=("fsdp", "ffn"))
        p.declare("shared_w2", (fs, d), scale=fs**-0.5, logical_axes=("ffn", "fsdp"))
    return p


def _batch_ways(ctx: ShardCtx = NO_MESH) -> int:
    """Number of mesh shards along the token/batch axes (1 with no mesh)."""
    if ctx.mesh is None:
        return 1
    from repro_torch.distributed.sharding import mesh_shape

    axes = ctx.rules.batch
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_shape(ctx.mesh)
    ways = 1
    for a in axes or ():
        ways *= sizes.get(a, 1)
    return ways


def route(probs: torch.Tensor, k: int, capacity: int):
    """Top-k routing of ``probs`` (W, Tl, E) float32 with per-row capacity
    slots. Returns (top_p (W, Tl, k) renormalized, top_e (W, Tl, k), pos
    (W, Tl·k) each pair's slot clamped to C−1, keep (W, Tl·k)).

    The choices are the k largest probabilities, the lower expert first on a
    tie (``jax.lax.top_k``'s order: a stable sort). ``pos`` counts, for each
    pair, the earlier pairs of its row (token-major, choice-minor) that chose
    the same expert; pairs at or past ``capacity`` are dropped."""
    e = probs.shape[-1]
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    e_flat = top_e.reshape(top_e.shape[0], -1)  # (W, Tl·k)
    # the count runs along the pairs, the innermost axis of (W, E, Tl·k):
    # a scan along an outer axis is a slow kernel on the card
    onehot = F.one_hot(e_flat, e).transpose(1, 2).contiguous()  # (W, E, Tl·k)
    pos_all = torch.cumsum(onehot, dim=2) - onehot  # exclusive count
    pos = torch.gather(pos_all, 1, e_flat[:, None, :])[:, 0, :]
    keep = pos < capacity
    return top_p, top_e, torch.clamp(pos, max=capacity - 1), keep


def _route_rows(probs: torch.Tensor, k: int, capacity: int):
    """``route`` on rows of probabilities (W, Tl, E), plus each row's count
    of tokens whose top-1 is each expert (W, E) float32."""
    top_p, top_e, pos, keep = route(probs, k, capacity)
    top1 = F.one_hot(top_e[..., 0], probs.shape[-1]).float().sum(1)
    return top_p, top_e, pos, keep, top1


def _dispatch_rows(xt, top_e, pos, keep, capacity: int, e: int):
    """Each (token, choice) pair of the rows xt (W, Tl, D) written to its
    slot: returns (the experts' input (W, E, C, D), src (W, E·C) — the pair
    each slot was filled from, or a row past the pairs for an empty slot)."""
    w, t_loc, d = xt.shape
    k = top_e.shape[-1]
    n_pairs = t_loc * k
    # a dropped pair goes to a row of its own past the E·C slots, which the
    # experts never read, so every index is written once and the gradient
    # is a plain gather
    e_flat = top_e.reshape(w, n_pairs)
    slots = e * capacity
    arange = torch.arange(n_pairs, device=xt.device)
    dest = torch.where(keep, e_flat * capacity + pos, slots + arange)  # (W, Tl·k), unique a row
    row0 = torch.arange(w, device=xt.device)[:, None] * (slots + n_pairs)
    pairs = xt[:, :, None, :].expand(w, t_loc, k, d).reshape(w * n_pairs, d)
    buf = xt.new_zeros(w * (slots + n_pairs), d)
    buf.index_put_(((dest + row0).reshape(-1),), pairs)
    ei = buf.reshape(w, slots + n_pairs, d)[:, :slots].reshape(w, e, capacity, d)
    src = (n_pairs + torch.arange(slots + n_pairs, device=xt.device)).repeat(w, 1)
    src.scatter_(1, dest, arange.expand(w, n_pairs))  # slot → its pair
    return ei, src[:, :slots]


def _combine_rows(eo, src, top_p):
    """Each slot's output (W, E, C, D) written back to the pair that filled
    it, an empty slot to a row of its own past the pairs (so a dropped
    pair's row stays 0, as the JAX package's keep mask makes it); the pairs
    weighted by their probabilities, a token's k pairs summed → (W, Tl, D)."""
    w, t_loc, k = top_p.shape
    d = eo.shape[-1]
    n_pairs = t_loc * k
    slots = src.shape[1]
    row0 = torch.arange(w, device=eo.device)[:, None] * (n_pairs + slots)
    back = eo.new_zeros(w * (n_pairs + slots), d)
    back.index_put_(((src + row0).reshape(-1),), eo.reshape(w * slots, d))
    pair_out = back.reshape(w, n_pairs + slots, d)[:, :n_pairs]
    weight = top_p.reshape(w, n_pairs, 1).to(eo.dtype)
    return (pair_out * weight).reshape(w, t_loc, k, d).sum(2)


def _expert_ffn(ei: torch.Tensor, p: ParamModule, cfg, ctx: ShardCtx = NO_MESH) -> torch.Tensor:
    """The experts' FFN on their slots ei (E, N, D) → (E, N, D). On a mesh
    it runs on each rank's experts with the weights' FSDP dim gathered —
    the layout the JAX package's constraints on ei and eo name — rather
    than on a strategy DTensor picks, which changes between torch
    versions; a partial sum where the rules shard ``expert_ffn``."""
    cdt = ei.dtype

    def local(x, w1, w3, w2):
        h = torch.bmm(x, w1.to(cdt))
        if w3 is not None:
            h = F.silu(h) * torch.bmm(x, w3.to(cdt))
        else:
            h = F.gelu(h, approximate="tanh")
        return torch.bmm(h, w2.to(cdt))

    w3 = p.w3 if cfg.mlp == "swiglu" else None
    if not ctx.active:
        return local(ei, p.w1, w3, p.w2)
    ffn = ctx.spec(("experts", None, "expert_ffn"), p.w1.shape)
    inner = ffn[2] if len(ffn) > 2 else None
    inputs = [(ei, ("experts", None, None)), (p.w1, ("experts", None, "expert_ffn")),
              (p.w2, ("experts", "expert_ffn", None))]
    if w3 is not None:
        inputs.insert(2, (w3, ("experts", None, "expert_ffn")))
        fn = local
    else:
        fn = lambda x, w1, w2: local(x, w1, None, w2)  # noqa: E731
    return ctx.local_call(fn, inputs, [(("experts", None, None), tuple(ei.shape),
                                        ctx.mesh_axes(inner))])


def _held_share(top_e, keep, moe):
    """The pairs of the experts this chip holds: (each pair's expert among
    the held ones (W, Tl, k), keep (W, Tl·k) — kept and held — and held
    (W, Tl, k))."""
    local = top_e - moe.first_held
    held = (local >= 0) & (local < moe.num_held)
    return local, keep & held.reshape(keep.shape), held


def _count_pairs(keep, held) -> None:
    """The counters ``moe.pairs_held`` (pairs routed to a held expert) and
    ``moe.pairs_dropped`` (those of them past capacity); ``held`` None when
    every expert is held. They read the device, so they count only while
    telemetry records and no graph is being captured."""
    if not telemetry.recording(keep.device):
        return
    if held is None:
        n_held, kept = keep.numel(), int(keep.sum())
    else:
        n_held, kept = int(held.sum()), int(keep.sum())
    telemetry.count("moe.pairs_held", n_held)
    telemetry.count("moe.pairs_dropped", n_held - kept)


def _moe_experts(xt: torch.Tensor, p: ParamModule, cfg, capacity: int,
                 ctx: ShardCtx = NO_MESH):
    """The MoE block on W rows of tokens xt (W, Tl, D), each row with its
    own ``capacity`` slots an expert; returns (out (W, Tl, D), aux): with
    ``num_held`` set, the held experts' part of out."""
    moe = cfg.moe
    cdt = xt.dtype
    w, t_loc, d = xt.shape
    k, e = moe.top_k, moe.num_experts
    rows = ("batch", None, None)

    logits = (xt @ p.router.to(cdt)).float()
    probs = torch.softmax(logits, dim=-1)  # (W, Tl, E)
    top_p, top_e, pos, keep, top1 = ctx.local_call(
        lambda pr: _route_rows(pr, k, capacity), [(probs, rows)],
        [(rows, (w, t_loc, k)), (rows, (w, t_loc, k)), (rows[:2], (w, t_loc * k)),
         (rows[:2], (w, t_loc * k)), (rows[:2], (w, e))])

    # Switch-style load-balancing loss (f_e carries no gradient)
    f_e = top1.sum(0) / (w * t_loc)
    p_e = probs.reshape(-1, e).mean(0)
    aux = e * torch.sum(f_e * p_e) * moe.aux_loss_weight

    held = None
    if moe.num_held:
        if ctx.active:
            raise NotImplementedError("an expert share (num_held) on a mesh")
        top_e, keep, held = _held_share(top_e, keep, moe)
        e = moe.num_held
    _count_pairs(keep, held)

    with telemetry.fenced_span("moe.experts", xt.device):
        ei, src = ctx.local_call(
            lambda x_, e_, p_, k_: _dispatch_rows(x_, e_, p_, k_, capacity, e),
            [(xt, ("batch", None, "embed")), (top_e, rows), (pos, rows[:2]), (keep, rows[:2])],
            [(("batch", None, None, "embed"), (w, e, capacity, d)),
             (rows[:2], (w, e * capacity))])
        # (W, E, C, D) → (E, W·C, D): each expert's slots of every row
        ei = ctx.constrain(ei, ("batch", None, None, "embed"))
        ei = ctx.constrain(ei.transpose(0, 1).reshape(e, w * capacity, d),
                           ("experts", None, "embed"))

        eo = ctx.constrain(_expert_ffn(ei, p, cfg, ctx), ("experts", None, "embed"))  # (E, W·C, D)
        eo = ctx.constrain(eo.reshape(e, w, capacity, d).transpose(0, 1),
                           ("batch", None, None, "embed"))

        out = ctx.local_call(
            _combine_rows,
            [(eo, ("batch", None, None, "embed")), (src, rows[:2]), (top_p, rows)],
            [(("batch", None, "embed"), (w, t_loc, d))])
    return out, aux


def _shared_ffn(x: torch.Tensor, p: ParamModule) -> torch.Tensor:
    """The shared expert: SiLU(x·W1) ⊙ (x·W3) · W2, every token."""
    cdt = x.dtype
    with telemetry.fenced_span("moe.shared", x.device):
        h = F.silu(x @ p.shared_w1.to(cdt)) * (x @ p.shared_w3.to(cdt))
        return h @ p.shared_w2.to(cdt)


def moe_fwd(x: torch.Tensor, p: ParamModule, cfg,
            ctx: ShardCtx = NO_MESH) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B,S,D), aux_loss scalar float32)."""
    moe = cfg.moe
    if moe.dispatch == "local":
        return _moe_fwd_local(x, p, cfg, ctx)
    bsz, seq, d = x.shape
    tokens = bsz * seq
    capacity = int(math.ceil(tokens * moe.top_k / moe.num_experts * moe.capacity_factor))
    xt = ctx.constrain(x.reshape(tokens, d), ("batch", "embed"))
    out, aux = _moe_experts(xt.reshape(1, tokens, d), p, cfg, capacity, ctx)
    out = ctx.constrain(out.reshape(tokens, d), ("batch", "embed"))
    out = out.reshape(bsz, seq, d)
    if moe.d_shared:
        if ctx.active:
            raise NotImplementedError("a shared expert (d_shared) on a mesh")
        out = out + _shared_ffn(x, p)
    return out, aux


def _moe_fwd_local(x: torch.Tensor, p: ParamModule, cfg,
                   ctx: ShardCtx = NO_MESH) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard capacity slots: each of the W batch shards assigns its own
    T/W tokens to its own C_loc slots an expert (``dispatch="local"``).
    Dropping semantics differ from the global formulation (capacity is
    enforced per shard), as in the JAX package. With no mesh W is 1."""
    moe = cfg.moe
    bsz, seq, d = x.shape
    tokens = bsz * seq
    w = _batch_ways(ctx)
    while tokens % w:
        w //= 2
    t_loc = tokens // w
    c_loc = int(math.ceil(t_loc * moe.top_k / moe.num_experts * moe.capacity_factor))
    xt = ctx.constrain(x.reshape(w, t_loc, d), ("batch", None, "embed"))
    out, aux = _moe_experts(xt, p, cfg, c_loc, ctx)
    out = ctx.constrain(out, ("batch", None, "embed")).reshape(bsz, seq, d)
    if moe.d_shared:
        if ctx.active:
            raise NotImplementedError("a shared expert (d_shared) on a mesh")
        out = out + _shared_ffn(x, p)
    return out, aux
