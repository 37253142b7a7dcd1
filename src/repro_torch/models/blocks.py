"""Decoder block of the port: token mixer (attn/swa/mamba/mamba2/rglru) +
MLP (dense or MoE).

One *block* = pre-norm mixer + residual, then (if the arch has an FFN)
pre-norm MLP + residual. Gemma-3 style ``sandwich_norm`` adds post-norms on
both sub-block outputs; granite's ``residual_multiplier`` scales each
sub-block's output before its residual add (x + m·f(norm(x))).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.models.attention import (
    attention_decode,
    attention_fwd,
    attention_params,
    init_kv_cache,
)
from repro_torch.models.common import NO_MESH, ParamModule, ShardCtx, rms_norm
from repro_torch.models.mamba import (
    init_mamba_cache,
    mamba_decode,
    mamba_fwd,
    mamba_params,
)
from repro_torch.models.mamba2 import mamba2_fwd, mamba2_params
from repro_torch.models.mlp import mlp_fwd, mlp_params, moe_fwd, moe_params
from repro_torch.models.rglru import (
    init_rglru_cache,
    rglru_decode,
    rglru_fwd,
    rglru_params,
)

__all__ = ["block_params", "block_fwd", "block_decode", "init_block_cache"]


def _has_mlp(cfg) -> bool:
    return cfg.moe is not None or cfg.d_ff > 0


def block_params(cfg, kind: str) -> ParamModule:
    d = cfg.d_model
    p = ParamModule()
    p.declare("ln1", (d,), init="zeros", logical_axes=("embed",))
    if kind in ("attn", "swa"):
        p.attn = attention_params(cfg)
    elif kind == "mamba":
        p.mixer = mamba_params(cfg)
    elif kind == "mamba2":
        p.mixer = mamba2_params(cfg)
    elif kind == "rglru":
        p.mixer = rglru_params(cfg)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    if cfg.sandwich_norm:
        p.declare("ln1_post", (d,), init="zeros", logical_axes=("embed",))
    if _has_mlp(cfg):
        p.declare("ln2", (d,), init="zeros", logical_axes=("embed",))
        p.mlp = moe_params(cfg) if cfg.moe is not None else mlp_params(cfg)
        if cfg.sandwich_norm:
            p.declare("ln2_post", (d,), init="zeros", logical_axes=("embed",))
    return p


def _mixer_theta(cfg, kind: str) -> float:
    if kind == "swa" and cfg.rope_theta_local is not None:
        return cfg.rope_theta_local
    return cfg.rope_theta


def _mlp_residual(x, p, cfg, ctx: ShardCtx, constrain: bool):
    """The FFN sub-block; returns (x, the MoE aux loss or None). The
    training/prefill forward constrains the normed input (``constrain``),
    the decode step does not, as in the JAX package."""
    aux = None
    if _has_mlp(cfg):
        h = rms_norm(x, p.ln2, cfg.norm_eps)
        if constrain:
            h = ctx.constrain(h, ("batch", "attn_seq", "embed"))
        if cfg.moe is not None:
            h, aux = moe_fwd(h, p.mlp, cfg, ctx)
        else:
            h = mlp_fwd(h, p.mlp, cfg, ctx)
        if cfg.sandwich_norm:
            h = rms_norm(h, p.ln2_post, cfg.norm_eps)
        x = x + _scaled(h, cfg)
    return x, aux


def _scaled(h, cfg):
    """A sub-block's output times ``cfg.residual_multiplier`` (no operation
    at 1.0)."""
    return h if cfg.residual_multiplier == 1.0 else h * cfg.residual_multiplier


def block_fwd(
    x: torch.Tensor,
    p: ParamModule,
    cfg,
    kind: str,
    positions: torch.Tensor,
    impl: str = "kernel",
    ctx: ShardCtx = NO_MESH,
) -> Tuple[torch.Tensor, Any, Optional[torch.Tensor]]:
    """Returns (x, mixer state, aux loss): the state is (k, v) for attention
    blocks, the decode cache {"conv", "ssm"} for mamba and {"conv", "h"} for
    rglru blocks — the prefill turns it into the block's decode cache, the
    training forward drops it — and None for mamba2 blocks, which train
    only (on no mesh); the aux loss is the MoE block's
    load-balancing loss (float32), None for a dense FFN, where the JAX
    package returns 0."""
    # the sequence-parallel boundary sits on the normed tensor, as in the
    # JAX package
    h = ctx.constrain(rms_norm(x, p.ln1, cfg.norm_eps), ("batch", "attn_seq", "embed"))
    if kind in ("attn", "swa"):
        window = cfg.window if kind == "swa" else 0
        h, state = attention_fwd(
            h, p.attn, cfg, positions, window=window,
            theta=_mixer_theta(cfg, kind), impl=impl, ctx=ctx,
        )
    elif kind == "mamba":
        h, state = mamba_fwd(h, p.mixer, cfg, impl=impl, ctx=ctx)
    elif kind == "mamba2":
        if ctx.active:
            raise NotImplementedError("mamba2 blocks on a mesh")
        h, state = mamba2_fwd(h, p.mixer, cfg), None
    else:  # rglru
        h, state = rglru_fwd(h, p.mixer, cfg, impl=impl, ctx=ctx)
    if cfg.sandwich_norm:
        h = rms_norm(h, p.ln1_post, cfg.norm_eps)
    x, aux = _mlp_residual(x + _scaled(h, cfg), p, cfg, ctx, constrain=True)
    return x, state, aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def init_block_cache(cfg, kind: str, batch: int, cache_len: int, dtype, device):
    if kind == "attn":
        return init_kv_cache(cfg, batch, cache_len, dtype, device)
    if kind == "swa":
        return init_kv_cache(cfg, batch, min(cache_len, cfg.window), dtype, device)
    if kind == "mamba":
        return init_mamba_cache(cfg, batch, dtype, device)
    if kind == "rglru":
        return init_rglru_cache(cfg, batch, dtype, device)
    raise ValueError(kind)


def block_decode(
    x: torch.Tensor, p: ParamModule, cfg, kind: str, cache, t: int,
    ctx: ShardCtx = NO_MESH,
) -> Tuple[torch.Tensor, Any]:
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if kind in ("attn", "swa"):
        window = cfg.window if kind == "swa" else 0
        h, cache = attention_decode(
            h, p.attn, cfg, cache, t, window=window, theta=_mixer_theta(cfg, kind), ctx=ctx,
        )
    elif kind == "mamba":
        h, cache = mamba_decode(h, p.mixer, cfg, cache, ctx=ctx)
    else:  # rglru
        h, cache = rglru_decode(h, p.mixer, cfg, cache, ctx=ctx)
    if cfg.sandwich_norm:
        h = rms_norm(h, p.ln1_post, cfg.norm_eps)
    return _mlp_residual(x + _scaled(h, cfg), p, cfg, ctx, constrain=False)[0], cache
