"""Architecture config: gemma3-27b (see DESIGN.md for source/tier)."""

from repro_torch.configs.base import (
    MambaSettings,
    ModelConfig,
    MoESettings,
    RGLRUSettings,
)

def config() -> ModelConfig:
    # Gemma-3-27B: 62 layers, 5 local (window 1024, θ=10k) : 1 global (θ=1M),
    # QK-norm, sandwich norms, scaled embeddings, huge vocab.
    return ModelConfig(
        name="gemma3-27b", vocab_size=262_144, d_model=5376, num_layers=62,
        num_heads=32, num_kv_heads=16, head_dim=128, d_ff=21_504,
        block_pattern=("swa", "swa", "swa", "swa", "swa", "attn"),
        window=1024, qk_norm=True, sandwich_norm=True, embed_scale=True,
        mlp="gelu", tie_embeddings=True,
        rope_theta=1_000_000.0, rope_theta_local=10_000.0, microbatches=16,
    )
