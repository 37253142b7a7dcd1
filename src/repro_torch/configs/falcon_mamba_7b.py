"""Architecture config: falcon-mamba-7b (see DESIGN.md for source/tier)."""

from repro_torch.configs.base import (
    MambaSettings,
    ModelConfig,
    MoESettings,
    RGLRUSettings,
)

def config() -> ModelConfig:
    # Falcon-Mamba-7B (arXiv:2410.05355): pure Mamba-1, attention-free.
    return ModelConfig(
        name="falcon-mamba-7b", vocab_size=65_024, d_model=4096, num_layers=64,
        num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0,
        block_pattern=("mamba",),
        mamba=MambaSettings(d_inner=8192, d_state=16, d_conv=4),
        tie_embeddings=False, microbatches=8,
    )
