"""Architecture config: recurrentgemma-9b (see DESIGN.md for source/tier)."""

from repro_torch.configs.base import (
    MambaSettings,
    ModelConfig,
    MoESettings,
    RGLRUSettings,
)

def config() -> ModelConfig:
    # RecurrentGemma-9B / Griffin (arXiv:2402.19427): pattern = 2 RG-LRU
    # blocks : 1 local-attention block (window 2048), GQA kv=1 (MQA).
    return ModelConfig(
        name="recurrentgemma-9b", vocab_size=256_000, d_model=4096,
        num_layers=38, num_heads=16, num_kv_heads=1, head_dim=256, d_ff=12_288,
        block_pattern=("rglru", "rglru", "swa"), window=2048,
        rglru=RGLRUSettings(d_inner=4096, conv_width=4, c=8.0),
        mlp="gelu", embed_scale=True, tie_embeddings=True,
        rope_theta=10_000.0, microbatches=8,
    )
