"""command-r-35b [dense] — parallel-block decoder, no biases.

Source: hf:CohereForAI/c4ai-command-r-v01 (unverified tier).
40L, d_model=8192, 64 heads (GQA kv=8, head_dim 128), d_ff=22528,
vocab 256000; Cohere parallel residual (x + attn(h) + ffn(h) with a shared
input LayerNorm), tied embeddings with logit_scale 0.0625, rotary.
"""
from repro_torch.models.lm import ModelConfig

from .base import reduce_cfg

ID = "command-r-35b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ID, family="dense",
        n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=22528, vocab=256_000,
        parallel_block=True, norm="layer",
        tie_embeddings=True, logit_scale=0.0625, act="silu",
    )


def reduced() -> ModelConfig:
    return reduce_cfg(full())
