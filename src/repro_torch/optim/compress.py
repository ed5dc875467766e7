"""Int8 error-feedback gradient compression (port of
``repro/optim/compress.py``).

Each step uses ``q = Q(g + e)`` and keeps ``e' = (g + e) - q``, so the
quantisation error is fed back rather than lost [Seide et al. 2014;
Karimireddy et al. 2019].  As in the reference, it is a quantise /
dequantise pass on the reduced gradient before the optimiser; the error
buffer lives in the train state and is checkpointed.  Per-tensor symmetric
int8 with an f32 scale; ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""
from __future__ import annotations

import torch

from ..models import common as cm


def quantize(g):
    """(int8 q, f32 scale) with ``scale = max|g| / 127 + 1e-12``."""
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale):
    return q.float() * scale


def init_error(params):
    """f32 zeros of the parameters' nesting and shapes."""
    return cm.tree_map(
        lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device), params)


@torch.no_grad()
def compress_grads(grads, error):
    """(dequantised grads, as seen after the reduction; new error), two
    trees of ``grads``' nesting."""
    errs = dict(cm.leaves(error))
    out = {}
    for path, g in cm.leaves(grads):
        x = g.float() + errs[path]
        q, s = quantize(x)
        deq = dequantize(q, s)
        out[path] = (deq, x - deq)
    return (cm.tree_map(lambda path, _: out[path][0], grads),
            cm.tree_map(lambda path, _: out[path][1], grads))
