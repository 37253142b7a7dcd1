"""Architecture registry: the 10 assigned configs, granite-4.0-h-small (the
port's own: the JAX package has no Mamba-2 mixer) + tiny smoke variants.

Every entry is constructed from the published configuration (sources in
DESIGN.md). ``tiny()`` derives a reduced same-family config for CPU smoke
tests (small widths/depths/experts/vocab — the structure, block pattern and
feature flags are preserved).

A copy of the JAX package's registry without ``input_specs``, which builds
``jax.ShapeDtypeStruct`` stand-ins for the sharded dry run (ROADMAP A13).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from repro_torch.configs.base import (
    Mamba2Settings,
    MambaSettings,
    ModelConfig,
    MoESettings,
    RGLRUSettings,
    ShapeConfig,
    SHAPES,
)
from repro_torch.configs.musicgen_large import config as _musicgen_large
from repro_torch.configs.internvl2_1b import config as _internvl2_1b
from repro_torch.configs.falcon_mamba_7b import config as _falcon_mamba_7b
from repro_torch.configs.granite_moe_1b import config as _granite_moe_1b
from repro_torch.configs.granite_4_0_h_small import config as _granite_4_0_h_small
from repro_torch.configs.qwen3_moe_235b import config as _qwen3_moe_235b
from repro_torch.configs.gemma3_27b import config as _gemma3_27b
from repro_torch.configs.qwen25_3b import config as _qwen25_3b
from repro_torch.configs.minitron_4b import config as _minitron_4b
from repro_torch.configs.h2o_danube3_4b import config as _h2o_danube3_4b
from repro_torch.configs.recurrentgemma_9b import config as _recurrentgemma_9b

__all__ = ["ARCHITECTURES", "get_config", "tiny", "list_archs"]


ARCHITECTURES: Dict[str, Callable[[], ModelConfig]] = {
    "musicgen-large": _musicgen_large,
    "internvl2-1b": _internvl2_1b,
    "falcon-mamba-7b": _falcon_mamba_7b,
    "granite-moe-1b-a400m": _granite_moe_1b,
    "qwen3-moe-235b-a22b": _qwen3_moe_235b,
    "gemma3-27b": _gemma3_27b,
    "qwen2.5-3b": _qwen25_3b,
    "minitron-4b": _minitron_4b,
    "h2o-danube-3-4b": _h2o_danube3_4b,
    "recurrentgemma-9b": _recurrentgemma_9b,
    "granite-4.0-h-small": _granite_4_0_h_small,
}


def list_archs():
    return sorted(ARCHITECTURES)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHITECTURES:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    return ARCHITECTURES[name]()


def tiny(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    period = len(cfg.block_pattern)
    layers = max(period + 1, 3)  # ≥1 full period + ≥1 leftover layer
    heads = min(cfg.num_heads, 4) if cfg.num_heads else 0
    kv = min(cfg.num_kv_heads, max(1, heads // 2)) if cfg.num_kv_heads else 0
    repl = {
        "vocab_size": min(cfg.vocab_size, 512),
        "d_model": 64,
        "num_layers": layers,
        "num_heads": heads,
        "num_kv_heads": kv,
        "head_dim": 16 if heads else 0,
        "d_ff": 128 if cfg.d_ff > 0 else 0,
        "window": min(cfg.window, 8) if cfg.window else 0,
        "microbatches": 1,
        "param_dtype": "float32",
        "compute_dtype": "float32",
    }
    if cfg.moe is not None:
        repl["moe"] = MoESettings(
            num_experts=4, top_k=2, d_expert=32,
            capacity_factor=cfg.moe.capacity_factor,
            aux_loss_weight=cfg.moe.aux_loss_weight,
            d_shared=48 if cfg.moe.d_shared else 0,
        )
    if cfg.mamba is not None:
        repl["mamba"] = MambaSettings(d_inner=128, d_state=8, d_conv=4, dt_rank=8)
    if cfg.mamba2 is not None:
        repl["mamba2"] = Mamba2Settings(num_heads=4, head_dim=16, d_state=8,
                                        n_groups=cfg.mamba2.n_groups, d_conv=4, chunk_size=8)
    if cfg.rglru is not None:
        repl["rglru"] = RGLRUSettings(d_inner=64, conv_width=4, c=8.0)
    return dataclasses.replace(cfg, **repl)
