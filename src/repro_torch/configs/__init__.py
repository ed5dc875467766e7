"""Architecture registry of the port: ``--arch <id>`` resolves through here.

``get(arch_id)`` / ``get_reduced(arch_id)`` return :class:`ModelConfig`s;
``ARCHS`` lists the ten architectures of the reference
(``repro/configs/__init__.py``), in its order.  Each module is the port's
own copy of the reference's; an unknown id raises ``KeyError``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.lm import ModelConfig

from . import (codeqwen1_5_7b, command_r_35b, gemma2_27b, granite_3_2b,
               granite_moe_1b_a400m, jamba_v0_1_52b, paligemma_3b,
               phi3_5_moe_42b, rwkv6_3b, seamless_m4t_large_v2)
from .shapes import SHAPES, ShapeCell, input_specs, skip_reason

_MODULES = [
    jamba_v0_1_52b, gemma2_27b, command_r_35b, granite_3_2b, codeqwen1_5_7b,
    granite_moe_1b_a400m, phi3_5_moe_42b, rwkv6_3b, seamless_m4t_large_v2,
    paligemma_3b,
]

ARCHS: dict[str, object] = {m.ID: m for m in _MODULES}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown architecture {arch!r}; known: "
                       f"{list(ARCHS)}")
    return ARCHS[arch]


def get(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).full()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_reduced(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).reduced()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


__all__ = ["ARCHS", "SHAPES", "ShapeCell", "get", "get_reduced",
           "input_specs", "skip_reason"]
