"""Assigned input shapes and their abstract inputs (port of
``repro/configs/shapes.py``).

Each LM architecture is paired with the four assigned shape cells:

* ``train_4k``      seq 4096,   global batch 256  -> ``train_step``
* ``prefill_32k``   seq 32768,  global batch 32   -> ``prefill``
* ``decode_32k``    seq 32768,  global batch 128  -> ``decode_step`` (1 new
  token against a KV cache of 32k)
* ``long_500k``     seq 524288, global batch 1    -> ``decode_step``;
  requires sub-quadratic sequence mixing, so it only runs for the SSM/hybrid
  architectures (skips recorded per cell).

:func:`input_specs` gives ``meta`` tensors (shapes and dtypes, no storage)
for every model input of a cell: the dry run (:mod:`repro_torch.launch.
dryrun`) runs the step on them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import lm


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}

# encoder length used for enc-dec decode cells (the self-cache is `seq`;
# cross-attention covers a fixed stubbed source utterance)
ENCDEC_DECODE_SRC = 4_096
# patch count for the VLM prefix (stubbed SigLIP: 448x448 / 14 -> 1024; the
# paligemma-224 default of 256 patches is used)
VLM_PATCHES = 256


def skip_reason(cfg: lm.ModelConfig, shape: ShapeCell) -> str | None:
    """Return why a cell is skipped (assignment rules), or None to run it."""
    if shape.name == "long_500k" and cfg.family not in ("hybrid", "ssm"):
        return ("full-attention architecture: 512k decode needs "
                "sub-quadratic sequence mixing (assignment rule)")
    return None


def input_specs(cfg: lm.ModelConfig, shape: ShapeCell) -> dict:
    """Abstract model inputs for one cell, as ``meta`` tensors.

    train  -> {'batch': {tokens, targets, loss_mask [, patches | frames]}}
    prefill-> {'batch': {tokens [, patches | frames]}, 'cache': ...}
    decode -> {'tokens': [B,1], 'cache': ...}

    The cache is :func:`repro_torch.models.lm.cache_struct`'s, whose
    ``index`` is the host int 0.
    """
    B, S = shape.batch, shape.seq

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    def tokens(T):
        return meta((B, T), torch.int32)

    def embeds(T):
        return meta((B, T, cfg.d_model), torch.float32)

    if shape.kind == "train":
        T = S - VLM_PATCHES if cfg.family == "vlm" else S
        batch = {"tokens": tokens(T), "targets": tokens(S),
                 "loss_mask": meta((B, S), torch.float32)}
        if cfg.family == "vlm":
            batch["patches"] = embeds(VLM_PATCHES)
        elif cfg.is_encdec:
            batch["frames"] = embeds(S)
        return {"batch": batch}

    if shape.kind == "prefill":
        enc_len = 0
        if cfg.family == "vlm":
            batch = {"tokens": tokens(S - VLM_PATCHES),
                     "patches": embeds(VLM_PATCHES)}
        elif cfg.is_encdec:
            batch = {"tokens": tokens(S), "frames": embeds(S)}
            enc_len = S
        else:
            batch = {"tokens": tokens(S)}
        return {"batch": batch,
                "cache": lm.cache_struct(cfg, B, S, enc_len=enc_len)}

    # decode
    enc_len = ENCDEC_DECODE_SRC if cfg.is_encdec else 0
    return {"tokens": tokens(1),
            "cache": lm.cache_struct(cfg, B, S, enc_len=enc_len)}
