"""Architecture registry of the port: ``--arch <id>`` resolves through here.

Only ``jamba-v0.1-52b`` is ported.  The reference's other architectures
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.lm import ModelConfig

from . import jamba_v0_1_52b

ARCHS: dict[str, object] = {jamba_v0_1_52b.ID: jamba_v0_1_52b}

# the reference's other architectures (repro/configs/__init__.py)
NOT_PORTED = ("gemma2-27b", "command-r-35b", "granite-3-2b",
              "codeqwen1.5-7b", "granite-moe-1b-a400m",
              "phi3.5-moe-42b-a6.6b", "rwkv6-3b", "seamless-m4t-large-v2",
              "paligemma-3b")


def _module(arch: str):
    if arch in ARCHS:
        return ARCHS[arch]
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"{arch} is not ported to repro_torch yet (ROADMAP queue 1, "
            f"item 14)")
    raise KeyError(f"unknown architecture {arch!r}; ported: {list(ARCHS)}")


def get(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).full()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_reduced(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).reduced()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


__all__ = ["ARCHS", "get", "get_reduced"]
