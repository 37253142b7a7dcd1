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
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamModule

__all__ = ["mlp_params", "mlp_fwd", "moe_params", "moe_fwd"]


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------
def mlp_params(cfg) -> ParamModule:
    d, f = cfg.d_model, cfg.d_ff
    p = ParamModule()
    p.declare("w1", (d, f), scale=d**-0.5)
    p.declare("w2", (f, d), scale=f**-0.5)
    if cfg.mlp == "swiglu":
        p.declare("w3", (d, f), scale=d**-0.5)
    return p


def mlp_fwd(x: torch.Tensor, p: ParamModule, cfg) -> torch.Tensor:
    cdt = x.dtype
    h = x @ p.w1.to(cdt)
    if cfg.mlp == "swiglu":
        h = F.silu(h) * (x @ p.w3.to(cdt))
    elif cfg.mlp == "gelu":
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    elif cfg.mlp == "relu2":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(f"unknown mlp kind {cfg.mlp!r}")
    return h @ p.w2.to(cdt)


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------
def moe_params(cfg) -> ParamModule:
    d, e, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_expert
    p = ParamModule()
    p.declare("router", (d, e), scale=d**-0.5)
    p.declare("w1", (e, d, f), scale=d**-0.5)
    p.declare("w2", (e, f, d), scale=f**-0.5)
    if cfg.mlp == "swiglu":
        p.declare("w3", (e, d, f), scale=d**-0.5)
    return p


def _batch_ways() -> int:
    """Number of shards along the token/batch axes: 1, since the port runs
    on one card with no mesh (sharding is ROADMAP A13)."""
    return 1


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


def _moe_experts(xt: torch.Tensor, p: ParamModule, cfg, capacity: int):
    """The MoE block on W rows of tokens xt (W, Tl, D), each row with its
    own ``capacity`` slots an expert; returns (out (W, Tl, D), aux)."""
    moe = cfg.moe
    cdt = xt.dtype
    w, t_loc, d = xt.shape
    k, e = moe.top_k, moe.num_experts
    n_pairs = t_loc * k

    logits = (xt @ p.router.to(cdt)).float()
    probs = torch.softmax(logits, dim=-1)  # (W, Tl, E)
    top_p, top_e, pos, keep = route(probs, k, capacity)

    # Switch-style load-balancing loss (f_e carries no gradient)
    f_e = F.one_hot(top_e[..., 0].reshape(-1), e).float().mean(0)
    p_e = probs.reshape(-1, e).mean(0)
    aux = e * torch.sum(f_e * p_e) * moe.aux_loss_weight

    # dispatch: each pair is written to its slot (e, pos); a dropped pair to
    # a row of its own past the E·C slots, which the experts never read, so
    # every index is written once and the gradient is a plain gather
    e_flat = top_e.reshape(w, n_pairs)
    slots = e * capacity
    arange = torch.arange(n_pairs, device=xt.device)
    dest = torch.where(keep, e_flat * capacity + pos, slots + arange)  # (W, Tl·k), unique a row
    row0 = torch.arange(w, device=xt.device)[:, None] * (slots + n_pairs)
    pairs = xt[:, :, None, :].expand(w, t_loc, k, d).reshape(w * n_pairs, d)
    buf = xt.new_zeros(w * (slots + n_pairs), d)
    buf.index_put_(((dest + row0).reshape(-1),), pairs)
    # (W, E, C, D) → (E, W·C, D): each expert's slots of every row
    ei = buf.reshape(w, slots + n_pairs, d)[:, :slots].reshape(w, e, capacity, d)
    ei = ei.transpose(0, 1).reshape(e, w * capacity, d)

    h = torch.bmm(ei, p.w1.to(cdt))
    if cfg.mlp == "swiglu":
        h = F.silu(h) * torch.bmm(ei, p.w3.to(cdt))
    else:
        h = F.gelu(h, approximate="tanh")
    eo = torch.bmm(h, p.w2.to(cdt))  # (E, W·C, D)

    # combine: each slot's output is written back to the pair that filled
    # it, an empty slot to a row of its own past the pairs (so a dropped
    # pair's row stays 0, as the JAX package's keep mask makes it); the
    # pairs weighted, a token's k pairs summed
    src = (n_pairs + torch.arange(slots + n_pairs, device=xt.device)).repeat(w, 1)
    src.scatter_(1, dest, arange.expand(w, n_pairs))  # slot → its pair
    row0 = torch.arange(w, device=xt.device)[:, None] * (n_pairs + slots)
    eo = eo.reshape(e, w, capacity, d).transpose(0, 1).reshape(w * slots, d)
    back = eo.new_zeros(w * (n_pairs + slots), d)
    back.index_put_(((src[:, :slots] + row0).reshape(-1),), eo)
    pair_out = back.reshape(w, n_pairs + slots, d)[:, :n_pairs]
    weight = top_p.reshape(w, n_pairs, 1).to(cdt)
    out = (pair_out * weight).reshape(w, t_loc, k, d).sum(2)
    return out, aux


def moe_fwd(x: torch.Tensor, p: ParamModule, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B,S,D), aux_loss scalar float32)."""
    moe = cfg.moe
    if moe.dispatch == "local":
        return _moe_fwd_local(x, p, cfg)
    bsz, seq, d = x.shape
    tokens = bsz * seq
    capacity = int(math.ceil(tokens * moe.top_k / moe.num_experts * moe.capacity_factor))
    out, aux = _moe_experts(x.reshape(1, tokens, d), p, cfg, capacity)
    return out.reshape(bsz, seq, d), aux


def _moe_fwd_local(x: torch.Tensor, p: ParamModule, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard capacity slots: each of the W batch shards assigns its own
    T/W tokens to its own C_loc slots an expert (``dispatch="local"``).
    Dropping semantics differ from the global formulation (capacity is
    enforced per shard), as in the JAX package. With no mesh W is 1."""
    moe = cfg.moe
    bsz, seq, d = x.shape
    tokens = bsz * seq
    w = _batch_ways()
    while tokens % w:
        w //= 2
    t_loc = tokens // w
    c_loc = int(math.ceil(t_loc * moe.top_k / moe.num_experts * moe.capacity_factor))
    out, aux = _moe_experts(x.reshape(w, t_loc, d), p, cfg, c_loc)
    return out.reshape(bsz, seq, d), aux
