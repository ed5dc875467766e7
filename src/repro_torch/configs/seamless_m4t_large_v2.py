"""seamless-m4t-large-v2 [audio] — encoder-decoder backbone (frontend stub).

Source: arXiv:2308.11596 / hf:facebook/seamless-m4t-v2-large.
Backbone only per the assignment: 24L encoder + 24L decoder, d_model=1024,
16 heads (kv=16, head_dim 64), d_ff=8192, vocab 256206; LayerNorm,
sinusoidal positions, QKV biases, ReLU FFN (NLLB lineage), tied
embeddings.  The speech frontend is a stub — the caller supplies
precomputed frame embeddings [B, S, d_model] (``frames``) to the encoder.
"""
from repro_torch.models.lm import ModelConfig

from .base import reduce_cfg

ID = "seamless-m4t-large-v2"


def full() -> ModelConfig:
    return ModelConfig(
        name=ID, family="encdec",
        n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_head=64, d_ff=8192, vocab=256_206,
        norm="layer", pos_embed="sinusoidal", use_rope=False,
        qkv_bias=True, act="relu", tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return reduce_cfg(full())
