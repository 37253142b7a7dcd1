"""Model / shape configuration dataclasses for the assigned architectures."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["MoESettings", "MambaSettings", "Mamba2Settings", "RGLRUSettings", "ModelConfig",
           "ShapeConfig", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class MoESettings:
    num_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden size
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # "allreduce": each data shard scatter-adds into a full (E, C, D) buffer
    #   which XLA then all-reduces — the naive GShard lowering (baseline).
    # "local": per-shard capacity slots — the scatter stays shard-local and
    #   the dispatch crosses the mesh as an all-to-all of only the routed
    #   tokens (≈32× less traffic at qwen3-moe scale; EXPERIMENTS.md §Perf).
    dispatch: str = "allreduce"
    # a shared SwiGLU expert of this width beside the routed ones (granite
    # 4.0-H); 0 = none
    d_shared: int = 0
    # the chip's share of an expert-parallel layer: the experts
    # first_held … first_held + num_held − 1 are held here, the router still
    # scores all num_experts and a pair routed elsewhere adds nothing;
    # 0 = every expert is held
    num_held: int = 0
    first_held: int = 0


@dataclasses.dataclass(frozen=True)
class MambaSettings:
    d_inner: int
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0  # 0 → ceil(d_model / 16)
    # XLA-path perf knob (§Perf): timesteps processed per scan iteration.
    # The while-loop carry round-trips HBM once per iteration; unrolling K
    # steps inside the body cuts carry traffic by K× (the Pallas kernel's
    # VMEM-resident carry is the limit of this lever).
    time_unroll: int = 1


@dataclasses.dataclass(frozen=True)
class Mamba2Settings:
    """Mamba-2 (SSD) mixer: ``num_heads`` heads of ``head_dim`` channels
    (d_inner = num_heads·head_dim), a state of ``d_state`` per head, B and C
    shared by the heads of each of ``n_groups`` groups, a causal depthwise
    conv of width ``d_conv`` and the chunk length of the chunked scan."""
    num_heads: int
    head_dim: int
    d_state: int = 128
    n_groups: int = 1
    d_conv: int = 4
    chunk_size: int = 256

    @property
    def d_inner(self) -> int:
        return self.num_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class RGLRUSettings:
    d_inner: int  # RG-LRU width (recurrentgemma: == d_model)
    conv_width: int = 4
    c: float = 8.0  # decay sharpness constant
    block_width: int = 0  # 0 → d_inner (diagonal gates computed blockwise)
    time_unroll: int = 1  # see MambaSettings.time_unroll


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    d_model: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    # Block pattern, repeated over the depth. Kinds:
    #   "attn"  — global attention;  "swa" — sliding-window attention;
    #   "mamba" — Mamba-1 block;     "rglru" — RG-LRU recurrent block;
    #   "mamba2" — Mamba-2 (SSD) mixer, trained only (no prefill/decode).
    block_pattern: Tuple[str, ...] = ("attn",)
    mlp: str = "swiglu"  # "swiglu" | "gelu" | "relu2"
    moe: Optional[MoESettings] = None
    mamba: Optional[MambaSettings] = None
    mamba2: Optional[Mamba2Settings] = None
    rglru: Optional[RGLRUSettings] = None
    window: int = 0  # sliding-window size for "swa" blocks
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    qkv_bias: bool = False
    qk_norm: bool = False
    sandwich_norm: bool = False  # gemma3: pre+post norms around each sub-block
    rope_theta: float = 10_000.0
    rope_theta_local: Optional[float] = None  # swa blocks (gemma3: 10k vs 1M)
    rope_fraction: float = 1.0  # partial rotary (minitron: 0.5)
    rope: bool = True  # False: attention without position embeddings (NoPE)
    attn_scale: float = 0.0  # softmax scale of the scores; 0 → head_dim^-0.5
    # muP multipliers (granite): embeddings ×, each sub-block's output ×
    # before its residual add, logits ÷; at 1.0 no operation is added
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    embed_inputs: bool = False  # stub frontend supplies (B,S,D) embeddings
    embed_scale: bool = False  # multiply embeddings by sqrt(d_model) (gemma)
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    param_dtype: str = "float32"
    embed_dtype: str = ""  # "" → param_dtype; "bfloat16" halves table gathers
    compute_dtype: str = "bfloat16"
    # distribution/memory knobs (per-arch defaults; hillclimb levers)
    microbatches: int = 1  # gradient-accumulation splits of the global batch
    remat: bool = True  # checkpoint each scanned block
    # what one checkpoint holds under remat: a period of the block pattern
    # (as the JAX package scans them) or a single layer, for a model whose
    # period is most of its depth (granite 4.0-H: 10 layers)
    remat_unit: str = "period"

    # ------------------------------------------------------------- derived
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def num_periods(self) -> int:
        return self.num_layers // self.pattern_period

    @property
    def num_leftover(self) -> int:
        return self.num_layers - self.num_periods * self.pattern_period

    @property
    def dt_rank(self) -> int:
        if self.mamba is None:
            return 0
        return self.mamba.dt_rank or -(-self.d_model // 16)

    def layer_kinds(self) -> Tuple[str, ...]:
        full = self.block_pattern * self.num_periods + self.block_pattern[: self.num_leftover]
        return full

    def is_sub_quadratic(self) -> bool:
        """True iff decode state is O(1)/O(window) in sequence length for
        every layer (long_500k eligibility; see DESIGN.md §4)."""
        return all(k != "attn" for k in self.block_pattern)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
