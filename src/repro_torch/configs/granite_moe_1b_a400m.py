"""granite-moe-1b-a400m [moe] — 32 experts top-8, granite multipliers.

Source: hf:ibm-granite/granite-3.0-1b-a400m-base.
24L, d_model=1024, 16 heads (GQA kv=8, head_dim 64), per-expert d_ff=512
(SwiGLU), vocab 49155; MoE on every layer, 32 experts top-8;
embedding_multiplier 12, residual_multiplier 0.22, attention_multiplier
0.015625, logits_scaling 6; tied embeddings.
"""
from repro_torch.models.lm import ModelConfig

from .base import reduce_cfg

ID = "granite-moe-1b-a400m"


def full() -> ModelConfig:
    return ModelConfig(
        name=ID, family="moe",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_head=64,
        d_ff=512, vocab=49155,
        n_experts=32, top_k=8, moe_period=1, moe_offset=0,
        embed_multiplier=12.0, residual_multiplier=0.22,
        attn_scale=0.015625, logit_scale=1.0 / 6.0,
        tie_embeddings=True, act="silu",
    )


def reduced() -> ModelConfig:
    return reduce_cfg(full(), top_k=2)
