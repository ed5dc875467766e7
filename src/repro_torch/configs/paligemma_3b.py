"""paligemma-3b [vlm] — SigLIP + gemma prefix-LM (vision frontend stub).

Source: arXiv:2407.07726 / hf:google/paligemma-3b-pt-224.
Backbone only per the assignment: gemma-2b decoder — 18L, d_model=2048,
8 heads (MQA kv=1, head_dim 256), d_ff=16384 (GeGLU), vocab 257216; gemma
(1+w) RMSNorm, embeddings scaled by sqrt(d); prefix-LM attention: the image
patch prefix (stubbed SigLIP embeddings, 256 patches at d_model) is
bidirectional, the text suffix causal.
"""
from repro_torch.models.lm import ModelConfig

from .base import reduce_cfg

ID = "paligemma-3b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ID, family="vlm",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_head=256,
        d_ff=16384, vocab=257_216,
        norm_offset=1.0, act="gelu", embed_scale=2048.0 ** 0.5,
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return reduce_cfg(full())
