"""Architecture config: granite-moe-1b-a400m (see DESIGN.md for source/tier)."""

from repro_torch.configs.base import (
    MambaSettings,
    ModelConfig,
    MoESettings,
    RGLRUSettings,
)

def config() -> ModelConfig:
    # ibm-granite/granite-3.0-1b-a400m-base: 32 experts top-8, d_expert=512.
    return ModelConfig(
        name="granite-moe-1b-a400m", vocab_size=49_155, d_model=1024,
        num_layers=24, num_heads=16, num_kv_heads=8, head_dim=64, d_ff=0,
        moe=MoESettings(num_experts=32, top_k=8, d_expert=512),
        mlp="swiglu", tie_embeddings=True, rope_theta=10_000.0,
        microbatches=2,
    )
