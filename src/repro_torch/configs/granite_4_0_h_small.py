"""Architecture config: granite-4.0-h-small (Granite 4.0-H Small, 32B-A9B).

Source: https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/main/config.json
(``model_type: granitemoehybrid``). 40 layers at d_model 4096, the period
of ``layer_types`` is ten — five Mamba-2 mixers, a NoPE GQA attention
layer, four Mamba-2 mixers (attention at 5, 15, 25, 35) — each with a
72-expert top-10 MoE FFN of width 768 (``intermediate_size``, read as the
expert width) beside a shared SwiGLU expert of 1536; μP multipliers;
tied embeddings over 100,352 tokens. Remat checkpoints each layer: the
period is a quarter of the model, and one checkpoint of it would hold ten
layers' activations at once.
"""

from repro_torch.configs.base import Mamba2Settings, ModelConfig, MoESettings


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-4.0-h-small", vocab_size=100_352, d_model=4096,
        num_layers=40, num_heads=32, num_kv_heads=8, head_dim=128, d_ff=0,
        block_pattern=("mamba2",) * 5 + ("attn",) + ("mamba2",) * 4,
        moe=MoESettings(num_experts=72, top_k=10, d_expert=768, d_shared=1536),
        mamba2=Mamba2Settings(num_heads=128, head_dim=64, d_state=128, n_groups=1,
                              d_conv=4, chunk_size=256),
        mlp="swiglu", tie_embeddings=True, norm_eps=1e-5, rope=False,
        attn_scale=0.0078125, embedding_multiplier=12.0, residual_multiplier=0.22,
        logits_scaling=16.0, remat_unit="layer",
    )
