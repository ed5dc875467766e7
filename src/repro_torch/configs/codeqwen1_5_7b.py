"""codeqwen1.5-7b [dense] — qwen1.5 architecture (QKV biases, full MHA KV).

Source: hf:Qwen/CodeQwen1.5-7B.
32L, d_model=4096, 32 heads (kv=32 -> MHA, head_dim 128), d_ff=13440
(SwiGLU), vocab 92416; attention QKV biases (qwen signature), rope theta
1e6 (long-context code model), untied embeddings.
"""
from repro_torch.models.lm import ModelConfig

from .base import reduce_cfg

ID = "codeqwen1.5-7b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ID, family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_head=128,
        d_ff=13440, vocab=92416,
        qkv_bias=True, rope_theta=1_000_000.0,
        tie_embeddings=False, act="silu",
    )


def reduced() -> ModelConfig:
    return reduce_cfg(full())
