"""Energy-vs-makespan Pareto sweeps over ``CloudParams`` grids (port of
``repro.experiments.pareto``).

A grid of :class:`~repro_torch.core.engine.CloudParams` points (power
tables, bandwidths, meter coefficients, scheduler codes) runs as one
batch through :func:`repro_torch.experiments.shard.run_batch`, and the
non-dominated set is taken from the meter stack's readings.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..core import engine
from ..core.energy import PowerStateTable
from . import shard


def param_grid(base: engine.CloudParams, **axes) -> list[engine.CloudParams]:
    """Cartesian grid of parameter points: each keyword names a
    ``CloudParams`` field, each value is the sequence of settings to sweep
    (``param_grid(base, net_bw=[60, 125], power=power_scale_grid())``);
    :func:`sweep` stacks them into one batch."""
    field_names = {f.name for f in dataclasses.fields(engine.CloudParams)}
    unknown = set(axes) - field_names
    if unknown:
        raise TypeError(f"unknown CloudParams field(s): {sorted(unknown)}")
    names = list(axes)
    return [dataclasses.replace(base, **dict(zip(names, combo)))
            for combo in itertools.product(*(axes[n] for n in names))]


def grid_labels(**axes) -> list[dict]:
    """The label dict for each :func:`param_grid` point, in grid order."""
    names = list(axes)
    return [dict(zip(names, combo))
            for combo in itertools.product(*(axes[n] for n in names))]


def power_scale_grid(idle_scales: Sequence[float] = (0.6, 0.8, 1.0),
                     peak_scales: Sequence[float] = (1.0,),
                     base: PowerStateTable | None = None
                     ) -> list[PowerStateTable]:
    """Power tables scanning idle and peak draw around ``base`` (paper
    Table 1 by default): the energy-proportionality frontier axis."""
    if base is None:
        base = PowerStateTable.simple()

    def f32(x):
        return torch.tensor(x, dtype=torch.float32)

    tables = []
    for i, p in itertools.product(idle_scales, peak_scales):
        p_min = base.p_min * f32(i)
        p_max = torch.maximum(base.p_max * f32(p), p_min)
        tables.append(PowerStateTable(mode=base.mode, p_min=p_min,
                                      p_max=p_max, duration=base.duration))
    return tables


def pareto_front(costs) -> np.ndarray:
    """Boolean mask of the non-dominated points of ``costs[N, M]`` (all
    objectives minimised).  A point is dominated when some other point is
    <= in every objective and < in at least one."""
    c = np.asarray(costs, np.float64)
    if c.ndim != 2:
        raise ValueError(f"costs must be [N, M], got shape {c.shape}")
    n = c.shape[0]
    mask = np.ones(n, bool)
    for i in range(n):
        dominators = (c <= c[i]).all(axis=1) & (c < c[i]).any(axis=1)
        if dominators.any():
            mask[i] = False
    return mask


def _reading_total(readings: dict, name: str, n: int) -> np.ndarray:
    """f64[B]: one scalar a batch point from a (possibly per-entity) meter
    reading."""
    if name not in readings:
        raise KeyError(
            f"no meter reading {name!r}; available: {sorted(readings)}")
    v = readings[name].cpu().numpy().astype(np.float64)
    return v.reshape(n, -1).sum(axis=1)


class ParetoResult(NamedTuple):
    rows: list[dict]        # per-point metrics + labels + on_frontier flag
    frontier: np.ndarray    # i64[F] indices of non-dominated points
    result: engine.CloudResult  # the full batched engine result


def sweep(spec: engine.CloudSpec, trace: engine.Trace,
          points: Sequence[engine.CloudParams], *,
          labels: Sequence[dict] | None = None,
          energy_reading: str = "iaas_total",
          t_stop: float = math.inf,
          sharded: bool = True, devices=None) -> ParetoResult:
    """Run every parameter point in one batch and take the
    energy-vs-makespan Pareto frontier from the meter stack.

    ``energy_reading`` names the meter to rank by (any
    ``res.readings(spec)`` key, e.g. ``"hvac"`` for a cooling-only
    frontier); a per-entity reading is summed to one scalar a point.
    ``devices`` as in :func:`repro_torch.experiments.shard.run_batch`."""
    points = list(points)
    res = shard.run_batch(spec, trace, engine.stack_params(points),
                          t_stop=t_stop, sharded=sharded, devices=devices)
    n = len(points)
    energy_j = _reading_total(res.readings(spec), energy_reading, n)
    makespan = res.t_end.cpu().numpy().astype(np.float64)
    done = torch.isfinite(res.completion).sum(-1).cpu().numpy()
    mask = pareto_front(np.stack([energy_j, makespan], axis=1))
    rows = []
    for i in range(n):
        row = dict(labels[i]) if labels is not None else {}
        rows.append({
            **{k: (float(v) if isinstance(v, (int, float)) else str(v))
               for k, v in row.items()},
            "point": i,
            "energy_kwh": float(energy_j[i]) / 3.6e6,
            "makespan_s": float(makespan[i]),
            "tasks_done": int(done[i]),
            "on_frontier": bool(mask[i]),
        })
    return ParetoResult(rows=rows, frontier=np.flatnonzero(mask), result=res)
