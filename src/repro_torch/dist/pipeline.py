"""Pipeline stages: GPipe-style microbatch scheduling (port of
``repro/dist/pipeline.py``).

:func:`gpipe` runs a stack of identical stages (parameters carry a leading
``[n_stages]`` axis) over a stream of microbatches.  The numbers are
exactly sequential stage application per microbatch, as the reference's.

Without a mesh, or on a mesh of one device, the stages run in order on
this device.  On a mesh whose ``stage_axis`` has ``n_stages`` ranks, rank
``s`` of that axis runs stage ``s`` alone, on its slice of the stacked
parameters, and the microbatches pass from rank to rank by point-to-point
sends in the GPipe order: at tick ``c`` stage ``s`` works on microbatch
``c - s``, so stage ``s + 1`` works on microbatch ``m - 1`` while stage
``s`` works on ``m``.  The last stage's outputs are then broadcast along
the stage axis, so every rank returns the whole result.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist

from ..models import common as cm
from . import sharding as shd


def _stage_group(mesh, stage_axis: str, n_stages: int, device):
    """(this rank's stage, the stage axis's group, its ranks) of ``mesh``
    (a DeviceMesh, or a mesh record over the started process group)."""
    from ..launch import mesh as mesh_mod
    if not hasattr(mesh, "mesh_dim_names"):
        mesh = mesh_mod.device_mesh(
            mesh, "cpu" if dist.is_initialized()
            and dist.get_backend() == "gloo" else device)
    sizes = shd.mesh_shape(mesh)
    if sizes.get(stage_axis) != n_stages:
        raise ValueError(f"gpipe of {n_stages} stages over mesh axis "
                         f"{stage_axis!r} of {sizes.get(stage_axis)} ranks")
    group = mesh.get_group(stage_axis)
    ranks = [dist.get_global_rank(group, i) for i in range(n_stages)]
    return mesh.get_local_rank(stage_axis), group, ranks


def gpipe(stage_fn: Callable, mesh, stage_axis: str, n_stages: int):
    """Build ``run(params, xs)``: ``xs[M, ...]`` microbatches through
    ``n_stages`` applications of ``stage_fn(stage_params, x)``.

    ``params`` leaves are stacked ``[n_stages, ...]`` (checked against
    ``n_stages``); a stage's output has its input's shape and dtype.
    ``mesh`` is ``None``, a mesh of one device, or a mesh (a DeviceMesh,
    or a record over the started process group) whose ``stage_axis`` has
    ``n_stages`` ranks: every rank of the axis calls ``run`` with the
    same arguments."""
    spread = mesh is not None and math.prod(
        shd.mesh_shape(mesh).values()) > 1

    def check(params):
        for path, leaf in cm.leaves(params):
            if tuple(leaf.shape[:1]) != (n_stages,):
                raise ValueError(
                    f"gpipe expects every params leaf stacked to "
                    f"[{n_stages}, ...]; got {tuple(leaf.shape)} at "
                    f"{'/'.join(path)}")

    def run(params, xs):
        check(params)
        stages = [cm.tree_map(lambda _, t: t[s], params)
                  for s in range(n_stages)]

        def through_stages(x):
            for p in stages:
                x = stage_fn(p, x)
            return x

        return torch.stack([through_stages(x) for x in xs.unbind(0)])

    def run_spread(params, xs):
        check(params)
        s, group, ranks = _stage_group(mesh, stage_axis, n_stages, xs.device)
        p = cm.tree_map(lambda _, t: t[s], params)
        M = xs.shape[0]
        ys = torch.empty_like(xs)
        sends = []
        for tick in range(M + n_stages - 1):
            m = tick - s
            if not 0 <= m < M:
                continue
            if s == 0:
                x = xs[m]
            else:
                x = torch.empty_like(xs[m])
                dist.irecv(x, src=ranks[s - 1], group=group).wait()
            y = stage_fn(p, x)
            if y.shape != x.shape or y.dtype != x.dtype:
                raise ValueError(f"stage output {tuple(y.shape)} "
                                 f"{y.dtype} is not its input's "
                                 f"{tuple(x.shape)} {x.dtype}")
            if s == n_stages - 1:
                ys[m] = y
            else:
                y = y.contiguous()
                sends.append((y, dist.isend(y, dst=ranks[s + 1],
                                            group=group)))
        for _, req in sends:
            req.wait()
        dist.broadcast(ys, src=ranks[-1], group=group)
        return ys

    return run_spread if spread else run
