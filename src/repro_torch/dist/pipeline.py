"""Pipeline stages: GPipe-style microbatch scheduling (port of
``repro/dist/pipeline.py``), on one device.

:func:`gpipe` runs a stack of identical stages (parameters carry a leading
``[n_stages]`` axis) over a stream of microbatches.  The numbers are
exactly sequential stage application per microbatch, as the reference's.
The reference places each stage on a slice of its mesh's stage axis; the
port runs on one device, so it takes no mesh or a mesh of one device, and
runs the stages in order.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from ..models import common as cm


def gpipe(stage_fn: Callable, mesh, stage_axis: str, n_stages: int):
    """Build ``run(params, xs)``: ``xs[M, ...]`` microbatches through
    ``n_stages`` applications of ``stage_fn(stage_params, x)``.

    ``params`` leaves are stacked ``[n_stages, ...]`` (checked against
    ``n_stages``).  ``mesh`` is ``None`` or a mesh of one device; one of
    more devices raises ``NotImplementedError`` (ROADMAP queue 1, item
    16)."""
    if mesh is not None and math.prod(dict(mesh.shape).values()) > 1:
        raise NotImplementedError(
            f"gpipe over a mesh of {dict(mesh.shape)} ({stage_axis!r} "
            f"stages on several devices) is not ported: the port runs on "
            f"one device (ROADMAP queue 1, item 16)")

    def run(params, xs):
        for path, leaf in cm.leaves(params):
            if tuple(leaf.shape[:1]) != (n_stages,):
                raise ValueError(
                    f"gpipe expects every params leaf stacked to "
                    f"[{n_stages}, ...]; got {tuple(leaf.shape)} at "
                    f"{'/'.join(path)}")
        stages = [cm.tree_map(lambda _, t: t[s], params)
                  for s in range(n_stages)]

        def through_stages(x):
            for p in stages:
                x = stage_fn(p, x)
            return x

        return torch.stack([through_stages(x) for x in xs.unbind(0)])

    return run
