"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave with MoE.

Source: arXiv:2403.19887 / hf:ai21labs/Jamba-v0.1.
32L, d_model=4096, 32 query heads (GQA kv=8, head_dim 128), d_ff=14336,
vocab 65536; MoE 16 experts top-2 on every 2nd layer
(expert_layer_period=2, offset=1); attention on every 8th layer
(attn_layer_period=8, offset=4); mamba d_state=16, d_conv=4, expand=2; no
positional embeddings (the mamba layers carry position).
"""
from repro_torch.models.lm import ModelConfig

from .base import reduce_cfg

ID = "jamba-v0.1-52b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ID, family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
        d_ff=14336, vocab=65536,
        n_experts=16, top_k=2, moe_period=2, moe_offset=1,
        attn_period=8, attn_offset=4,
        mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
        use_rope=False, pos_embed="none",
        tie_embeddings=False, act="silu",
    )


def reduced() -> ModelConfig:
    return reduce_cfg(full())
