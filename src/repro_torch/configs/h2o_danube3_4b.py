"""Architecture config: h2o-danube-3-4b (see DESIGN.md for source/tier)."""

from repro_torch.configs.base import (
    MambaSettings,
    ModelConfig,
    MoESettings,
    RGLRUSettings,
)

def config() -> ModelConfig:
    # H2O-Danube-3-4B (arXiv:2401.16818 lineage): llama+mistral mix with
    # sliding-window attention.
    return ModelConfig(
        name="h2o-danube-3-4b", vocab_size=32_000, d_model=3840, num_layers=24,
        num_heads=32, num_kv_heads=8, head_dim=120, d_ff=10_240,
        block_pattern=("swa",), window=4096,
        mlp="swiglu", tie_embeddings=False, rope_theta=10_000.0,
        microbatches=4,
    )
