"""Architecture config: musicgen-large (see DESIGN.md for source/tier)."""

from repro_torch.configs.base import (
    MambaSettings,
    ModelConfig,
    MoESettings,
    RGLRUSettings,
)

def config() -> ModelConfig:
    # MusicGen-large decoder (arXiv:2306.05284): backbone only; the EnCodec
    # frontend is a stub — inputs are precomputed frame embeddings.
    return ModelConfig(
        name="musicgen-large", vocab_size=2048, d_model=2048, num_layers=48,
        num_heads=32, num_kv_heads=32, head_dim=64, d_ff=8192,
        mlp="gelu", embed_inputs=True, tie_embeddings=False,
        rope_theta=10_000.0, microbatches=4,
    )
