"""granite-3-2b [dense] — GQA llama-style with granite scale multipliers.

Source: hf:ibm-granite/granite-3.0-2b-base.
40L, d_model=2048, 32 heads (GQA kv=8, head_dim 64), d_ff=8192 (SwiGLU),
vocab 49155; embedding_multiplier 12, residual_multiplier 0.22,
attention_multiplier 0.015625 (used as the attention scale),
logits_scaling 8 (logits divided by 8); tied embeddings.
"""
from repro_torch.models.lm import ModelConfig

from .base import reduce_cfg

ID = "granite-3-2b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ID, family="dense",
        n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, d_head=64,
        d_ff=8192, vocab=49155,
        embed_multiplier=12.0, residual_multiplier=0.22,
        attn_scale=0.015625, logit_scale=1.0 / 8.0,
        tie_embeddings=True, act="silu",
    )


def reduced() -> ModelConfig:
    return reduce_cfg(full())
