"""rwkv6-3b [ssm] — Finch: attention-free, data-dependent decay.

Source: arXiv:2404.05892 / hf:RWKV/rwkv-6-world-3b.
32L, d_model=2560 (40 heads of 64), channel-mix d_ff=8960, vocab 65536;
LayerNorm convention, untied embeddings.  O(1) decode state per layer
(head-wise 64x64 matrices + token shifts) — the arch that makes the
``long_500k`` cell trivial.
"""
from repro_torch.models.lm import ModelConfig

from .base import reduce_cfg

ID = "rwkv6-3b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ID, family="ssm",
        n_layers=32, d_model=2560, d_ff=8960, vocab=65536,
        n_heads=40, n_kv_heads=40, d_head=64, rwkv_head_size=64,
        norm="layer", use_rope=False, pos_embed="none",
        tie_embeddings=False,
    )


def reduced() -> ModelConfig:
    return reduce_cfg(full())
