"""Architecture config: qwen2.5-3b (see DESIGN.md for source/tier)."""

from repro_torch.configs.base import (
    MambaSettings,
    ModelConfig,
    MoESettings,
    RGLRUSettings,
)

def config() -> ModelConfig:
    # Qwen2.5-3B: GQA kv=2, QKV bias, tied embeddings.
    return ModelConfig(
        name="qwen2.5-3b", vocab_size=151_936, d_model=2048, num_layers=36,
        num_heads=16, num_kv_heads=2, head_dim=128, d_ff=11_008,
        mlp="swiglu", qkv_bias=True, tie_embeddings=True,
        rope_theta=1_000_000.0, microbatches=4,
    )
