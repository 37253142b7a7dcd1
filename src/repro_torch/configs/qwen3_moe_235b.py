"""Architecture config: qwen3-moe-235b-a22b (see DESIGN.md for source/tier)."""

from repro_torch.configs.base import (
    MambaSettings,
    ModelConfig,
    MoESettings,
    RGLRUSettings,
)

def config() -> ModelConfig:
    # Qwen3-MoE family scaled per assignment: 94L, 128 experts top-8,
    # d_expert=1536, GQA kv=4, QK-norm (Qwen3 replaces QKV bias with q/k norm).
    return ModelConfig(
        name="qwen3-moe-235b-a22b", vocab_size=151_936, d_model=4096,
        num_layers=94, num_heads=64, num_kv_heads=4, head_dim=128, d_ff=0,
        moe=MoESettings(num_experts=128, top_k=8, d_expert=1536),
        mlp="swiglu", qk_norm=True, tie_embeddings=False,
        rope_theta=1_000_000.0, microbatches=16,
    )
