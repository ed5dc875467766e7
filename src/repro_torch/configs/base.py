"""Config helpers shared by the per-architecture modules (port of
``repro/configs/base.py``).

Every arch module exposes ``full()`` (the published configuration) and
``reduced()`` (a same-family miniature for CPU tests: identical layer pattern
and feature set, tiny dims, f32 compute).
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.lm import ModelConfig


def reduce_cfg(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a full config to smoke-test size, preserving its structure."""
    # keep one repetition of the layer pattern (hybrids need the full period)
    if cfg.attn_period > 0:
        n_layers = cfg.attn_period
    elif cfg.local_global_period > 0:
        n_layers = 2 * cfg.local_global_period
    else:
        n_layers = 2
    heads = min(cfg.n_heads, 4)
    kv = max(1, min(cfg.n_kv_heads, heads if cfg.n_kv_heads >= cfg.n_heads
                    else heads // 2))
    small = dict(
        n_layers=n_layers,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        d_head=16,
        d_ff=128,
        vocab=512,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        window=16 if cfg.window else 0,
        enc_layers=2 if cfg.enc_layers else 0,
        rwkv_head_size=16,
        embed_scale=8.0 if cfg.embed_scale else None,
        compute_dtype="float32",
        scan_chunk=16,
        q_chunk=32,
        k_chunk=32,
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
