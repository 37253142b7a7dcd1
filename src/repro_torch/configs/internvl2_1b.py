"""Architecture config: internvl2-1b (see DESIGN.md for source/tier)."""

from repro_torch.configs.base import (
    MambaSettings,
    ModelConfig,
    MoESettings,
    RGLRUSettings,
)

def config() -> ModelConfig:
    # InternVL2-1B LLM backbone = Qwen2-0.5B family (arXiv:2404.16821):
    # GQA kv=2, QKV bias; ViT patch frontend is a stub.
    return ModelConfig(
        name="internvl2-1b", vocab_size=151_655, d_model=896, num_layers=24,
        num_heads=14, num_kv_heads=2, head_dim=64, d_ff=4864,
        mlp="swiglu", qkv_bias=True, embed_inputs=True, tie_embeddings=True,
        rope_theta=1_000_000.0, microbatches=2,
    )
