"""Architecture config: minitron-4b (see DESIGN.md for source/tier)."""

from repro_torch.configs.base import (
    MambaSettings,
    ModelConfig,
    MoESettings,
    RGLRUSettings,
)

def config() -> ModelConfig:
    # Minitron-4B (arXiv:2407.14679): pruned Nemotron — squared-ReLU MLP,
    # partial rotary (50%), untied huge vocab.
    return ModelConfig(
        name="minitron-4b", vocab_size=256_000, d_model=3072, num_layers=32,
        num_heads=24, num_kv_heads=8, head_dim=128, d_ff=9216,
        mlp="relu2", rope_fraction=0.5, tie_embeddings=False,
        rope_theta=10_000.0, microbatches=8,
    )
