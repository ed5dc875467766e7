"""AdamW with decoupled weight decay and global-norm clipping (port of
``repro/optim/adamw.py``).

f32 moments, bias correction, a per-call learning rate (a 0-d tensor from
:mod:`repro_torch.optim.schedule`), and the global gradient norm clipped
before the moments.  The reference's constants: b1 0.9, b2 0.95, eps 1e-8.

:func:`update` writes the new parameters and moments into the given ones
(the reference returns new arrays, and its launcher donates the old ones
to the jitted step), a slice of a leaf at a time, so that a step holds one
slice's temporaries beside the state.

On a mesh (DTensor leaves) the global norm is reduced over the whole
mesh, and the update, elementwise once the clip scale is known, runs on
each rank's local shards of the parameter, its moments and its gradient
(the gradient first placed as the parameter is).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..dist import sharding as shd
from ..models import common as cm


# elements of a leaf updated at a time: the update is elementwise, so the
# slices change no number and bound its temporaries (a whole stacked leaf
# of granite-3-2b's is 5 GiB in f32, and the update holds ~6 temporaries)
_SLICE = 1 << 24


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32, 0-d
    m: dict
    v: dict


def init(params) -> AdamWState:
    def zeros():
        return cm.tree_map(
            lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device), params)
    dev = cm.leaves(params)[0][1].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros(), v=zeros())


@torch.no_grad()
def global_norm(tree):
    """sqrt of the sum of every leaf's sum of squares, in f32, the leaves
    taken in sorted-key order as the reference's ``jax.tree.leaves``; a
    plain tensor, reduced over the mesh for DTensor leaves."""
    total = None
    for _, x in cm.leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return shd.full(torch.sqrt(total))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return cm.tree_map(lambda _, g: g * scale, grads), gn


def _clip_scale(gn, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


@torch.no_grad()
def update(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.95,
           eps=1e-8, weight_decay=0.1, max_grad_norm=1.0):
    """One AdamW step written into ``params`` and ``state``'s moments, a
    slice of each leaf at a time.  Returns (params, new state, metrics)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm=max_grad_norm)
    step = state.step + 1
    stepf = shd.local(step).float()
    b1c = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=stepf.device), stepf)
    lr = torch.as_tensor(shd.local(lr), dtype=torch.float32,
                         device=stepf.device)
    gs, ms, vs = (dict(cm.leaves(t)) for t in (grads, state.m, state.v))
    for path, p in cm.leaves(params):
        g = shd.like(gs[path], p)
        flat = [shd.local(t).view(-1) for t in (p, ms[path], vs[path])]
        flat.append(shd.local(g).reshape(-1))
        for i in range(0, flat[0].numel(), _SLICE):
            p_, m, v, g = (t[i:i + _SLICE] for t in flat)
            g = g.float() * scale
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            mh = m / b1c
            vh = v / b2c
            step_v = mh / (torch.sqrt(vh) + eps) + weight_decay * p_.float()
            p_.copy_(p_.float() - lr * step_v)
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gn}
