"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2.

Source: hf:microsoft/Phi-3.5-MoE-instruct.
32L, d_model=4096, 32 heads (GQA kv=8, head_dim 128), per-expert d_ff=6400
(SwiGLU), vocab 32064; MoE on every layer, 16 experts top-2; LayerNorm
(PhiMoE convention), attention biases, untied embeddings.
"""
from repro_torch.models.lm import ModelConfig

from .base import reduce_cfg

ID = "phi3.5-moe-42b-a6.6b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ID, family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
        d_ff=6400, vocab=32064,
        n_experts=16, top_k=2, moe_period=1, moe_offset=0,
        norm="layer", qkv_bias=True,
        tie_embeddings=False, act="silu",
    )


def reduced() -> ModelConfig:
    return reduce_cfg(full())
