"""gemma2-27b [dense] — alternating local/global attention, logit softcaps.

Source: arXiv:2408.00118 / hf:google/gemma-2-27b.
46L, d_model=4608, 32 heads (GQA kv=16, head_dim 128), d_ff=36864 (GeGLU),
vocab 256000; sliding window 4096 on every other layer; attention softcap
50, final logit softcap 30; query scale (query_pre_attn_scalar=144)^-1/2;
RMSNorm with (1+w) and sandwich (pre+post) norms; embeddings scaled by
sqrt(d_model); tied embeddings.
"""
from repro_torch.models.lm import ModelConfig

from .base import reduce_cfg

ID = "gemma2-27b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ID, family="dense",
        n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_head=128,
        d_ff=36864, vocab=256_000,
        window=4096, local_global_period=2,
        attn_softcap=50.0, final_softcap=30.0,
        attn_scale=144.0 ** -0.5,
        sandwich_norm=True, norm_offset=1.0, act="gelu",
        tie_embeddings=True, embed_scale=4608.0 ** 0.5,
    )


def reduced() -> ModelConfig:
    return reduce_cfg(full())
