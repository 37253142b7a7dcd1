"""Roofline-term computation: the JAX package's ``repro.launch.roofline``,
with the H100 as the port's target.

    compute term    = HLO_FLOPs / (chips × peak_FLOP/s)
    memory term     = HLO_bytes / (chips × HBM_bw)
    collective term = collective_bytes / (chips × link_bw)

plus the analytic MODEL_FLOPS (hardware-independent "useful" flops):
6·N_active·tokens for training (fwd+bwd), 2·N_active·tokens for inference,
plus the attention score/PV terms that the 6N·D rule omits (they dominate
32k-cache decode for small models, so we must count them to judge
useful-compute ratio honestly).

Note on per-device vs global: the port's dry-run counts the operations
and bytes of one rank's program (``op_analysis`` on the local shards), as
``cost_analysis()`` of an SPMD-partitioned executable reports the
per-device program, so they are divided by nothing; MODEL_FLOPS is global
and divided by the chip count. The ``hlo_*`` argument names are the JAX
package's; the port passes its traced counts.

Targets: ``H100_SXM`` holds NVIDIA's data-sheet figures for one H100 SXM
(bf16 dense 989e12 FLOP/s, HBM3 3.35e12 B/s, 80 GB; NVLink 4 at 450e9 B/s
a direction) — datasheet peaks at the 700 W limit, not measurements.
``V5E`` is the JAX package's TPU target, kept only so the twin tests can
hold this module's arithmetic to the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig

__all__ = ["V5E", "H100_SXM", "HardwareTarget", "roofline_terms", "model_flops",
           "count_params"]


@dataclasses.dataclass(frozen=True)
class HardwareTarget:
    name: str
    peak_flops: float  # per chip, bf16
    hbm_bw: float  # bytes/s per chip
    link_bw: float  # bytes/s per link (one direction)
    hbm_bytes: float = 0.0  # device memory per chip


V5E = HardwareTarget(name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9, link_bw=50e9,
                     hbm_bytes=16e9)
H100_SXM = HardwareTarget(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12,
                          link_bw=450e9, hbm_bytes=80e9)


def count_params(cfg: ModelConfig) -> Dict[str, float]:
    """Analytic parameter counts (exactly matches the builder structure)."""
    d, v = cfg.d_model, cfg.vocab_size
    embed = v * d
    head = 0 if cfg.tie_embeddings else d * v

    per_kind: Dict[str, float] = {}
    attn = d * cfg.num_heads * cfg.head_dim + 2 * d * cfg.num_kv_heads * cfg.head_dim \
        + cfg.num_heads * cfg.head_dim * d
    if cfg.qkv_bias:
        attn += (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    if cfg.qk_norm:
        attn += 2 * cfg.head_dim
    per_kind["attn"] = per_kind["swa"] = attn

    if cfg.mamba is not None:
        m = cfg.mamba
        dtr = cfg.dt_rank
        per_kind["mamba"] = (
            d * 2 * m.d_inner + m.d_conv * m.d_inner + m.d_inner
            + m.d_inner * (dtr + 2 * m.d_state) + dtr * m.d_inner + m.d_inner
            + m.d_inner * m.d_state + m.d_inner + m.d_inner * d
        )
    if cfg.rglru is not None:
        r = cfg.rglru
        per_kind["rglru"] = (
            2 * d * r.d_inner + r.conv_width * r.d_inner + r.d_inner
            + 2 * (r.d_inner * r.d_inner + r.d_inner) + r.d_inner + r.d_inner * d
        )

    if cfg.moe is not None:
        e, f = cfg.moe.num_experts, cfg.moe.d_expert
        n_mats = 3 if cfg.mlp == "swiglu" else 2
        mlp_total = d * e + e * n_mats * d * f
        mlp_active = d * e + cfg.moe.top_k * n_mats * d * f
    elif cfg.d_ff > 0:
        n_mats = 3 if cfg.mlp == "swiglu" else 2
        mlp_total = mlp_active = n_mats * d * cfg.d_ff
    else:
        mlp_total = mlp_active = 0

    total = embed + head
    active = embed + head
    norms = d  # final norm
    for kind in cfg.layer_kinds():
        mixer = per_kind[kind]
        total += mixer + mlp_total + 2 * d
        active += mixer + mlp_active + 2 * d
    total += norms
    active += norms
    return {
        "total": float(total),
        "active": float(active),
        "embed": float(embed + head),
        "backbone": float(total - embed - head),
        "backbone_active": float(active - embed - head),
    }


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic useful FLOPs for one step of this cell (global)."""
    counts = count_params(cfg)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens, mult = b * s, 6.0
    elif shape.kind == "prefill":
        tokens, mult = b * s, 2.0
    else:  # decode: one token per sequence
        tokens, mult = b * 1, 2.0

    # weight matmuls (backbone without embedding gather) + LM head
    flops = mult * counts["backbone_active"] * tokens
    flops += mult * cfg.d_model * cfg.vocab_size * (
        tokens if shape.kind != "prefill" else b  # prefill head = last pos only
    )

    # attention score+PV matmuls: 2 matmuls × 2 FLOP × Hq × Dh × kv_len
    fwd_bwd = 3.0 if shape.kind == "train" else 1.0
    for kind in cfg.layer_kinds():
        if kind not in ("attn", "swa"):
            continue
        if shape.kind == "decode":
            kv_len = min(s, cfg.window) if kind == "swa" and cfg.window else s
            flops += fwd_bwd * 4.0 * cfg.num_heads * cfg.head_dim * kv_len * tokens
        else:
            if kind == "swa" and cfg.window and cfg.window < s:
                avg_kv = cfg.window / 1.0  # each query sees ~window keys
            else:
                avg_kv = s / 2.0  # causal average
            flops += fwd_bwd * 4.0 * cfg.num_heads * cfg.head_dim * avg_kv * b * s
    # mamba/rglru recurrence flops: O(d_inner·d_state) per token — small but counted
    for kind in cfg.layer_kinds():
        if kind == "mamba" and cfg.mamba is not None:
            flops += fwd_bwd * 2.0 * 9 * cfg.mamba.d_inner * cfg.mamba.d_state * tokens
        if kind == "rglru" and cfg.rglru is not None:
            flops += fwd_bwd * 2.0 * 6 * cfg.rglru.d_inner * tokens
    return float(flops)


def roofline_terms(
    hlo_flops: float,
    hlo_bytes: float,
    coll_bytes: float,
    chips: int,
    cfg: Optional[ModelConfig] = None,
    shape: Optional[ShapeConfig] = None,
    hw: HardwareTarget = H100_SXM,
    per_device: bool = True,
) -> Dict[str, float]:
    """All three terms in seconds (+ metadata). ``per_device=True`` means the
    HLO numbers come from the partitioned (per-device) module."""
    div = 1 if per_device else chips
    t_compute = (hlo_flops / div) / hw.peak_flops
    t_memory = (hlo_bytes / div) / hw.hbm_bw
    # conservatively one active link (a v5e chip has 4 ICI links, an H100
    # 18 NVLink 4 links behind one 450 GB/s a-direction figure)
    t_coll = (coll_bytes / div) / hw.link_bw
    out = {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_coll,
        "bottleneck": max(
            ("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
            key=lambda kv: kv[1],
        )[0],
    }
    if cfg is not None and shape is not None:
        mf = model_flops(cfg, shape)
        out["model_flops_global"] = mf
        out["model_flops_per_chip"] = mf / chips
        hlo_per_chip = hlo_flops / div
        out["useful_ratio"] = (mf / chips) / hlo_per_chip if hlo_per_chip else 0.0
        dom = max(t_compute, t_memory, t_coll)
        out["roofline_fraction"] = (
            ((mf / chips) / hw.peak_flops) / dom if dom > 0 else 0.0
        )
    return out
