"""Scheduler tournaments: VM x PM policy grids in one batch (port of
``repro.experiments.tournament``).

Scheduler identity is ``CloudParams`` data (integer codes into the policy
registry), so any grid of (``vm_sched``, ``pm_sched``) cells runs as one
batch through :func:`repro_torch.experiments.shard.run_batch` and is
scored from the meter stack.  The default axes are every registered
policy (:func:`repro_torch.sched.registry.names`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch

from ..core import engine
from ..sched import registry
from . import shard


def scheduler_grid(vm_scheds: Sequence[str | int] | None = None,
                   pm_scheds: Sequence[str | int] | None = None
                   ) -> list[tuple]:
    """The cross product of VM x PM scheduler cells; each axis defaults to
    every registered policy of its layer (3 x 5 with the builtins)."""
    if vm_scheds is None:
        vm_scheds = registry.names("vm")
    if pm_scheds is None:
        pm_scheds = registry.names("pm")
    return [(v, p) for v in vm_scheds for p in pm_scheds]


def _sched_name(value, layer: str) -> str:
    return value if isinstance(value, str) else registry.name_of(layer, value)


class TournamentResult(NamedTuple):
    rows: list[dict]            # one row per (vm_sched, pm_sched) cell
    result: engine.CloudResult  # full batched engine result


def run(spec: engine.CloudSpec, trace: engine.Trace,
        base_params: engine.CloudParams, *,
        schedulers: Sequence[tuple] | None = None,
        sharded: bool = True, devices=None) -> TournamentResult:
    """Score every ``(vm_sched, pm_sched)`` cell of ``schedulers`` (default
    :func:`scheduler_grid`) on one trace, in one batch.

    Each row reports IT energy (the whole-IaaS meter), the job-attributed
    share (per-VM Eq. 6 meters) and the unattributed idle waste when the
    stack has them, facility cooling (an HVAC indirect meter) when
    present, the makespan, and completion and queueing statistics."""
    if schedulers is None:
        schedulers = scheduler_grid()
    schedulers = list(schedulers)
    points = [dataclasses.replace(base_params, vm_sched=v, pm_sched=p)
              for v, p in schedulers]
    res = shard.run_batch(spec, trace, engine.stack_params(points),
                          sharded=sharded, devices=devices)
    readings = res.readings(spec)
    done = torch.isfinite(res.completion)
    mean_completion = (torch.where(done, res.completion, 0.0).sum(-1)
                       / torch.clamp_min(done.sum(-1), 1))
    cols = dict(iaas=readings["iaas_total"], t_end=res.t_end,
                done=done.sum(-1), rejected=res.rejected.sum(-1),
                mean_completion=mean_completion, events=res.n_events)
    if "vm" in readings:
        cols.update(job=readings["vm"].sum(-1),
                    idle=readings["vm_unattributed"])
    if "hvac" in readings:
        cols["hvac"] = readings["hvac"]
    cols = {k: v.cpu().tolist() for k, v in cols.items()}
    rows = []
    for b, (vm_sched, pm_sched) in enumerate(schedulers):
        row = {
            "vm_sched": _sched_name(vm_sched, "vm"),
            "pm_sched": _sched_name(pm_sched, "pm"),
            "energy_kwh": cols["iaas"][b] / 3.6e6,
            "makespan_s": cols["t_end"][b],
            "jobs_done": int(cols["done"][b]),
            "jobs_rejected": int(cols["rejected"][b]),
            "mean_completion_s": cols["mean_completion"][b],
            "events": int(cols["events"][b]),
        }
        if "job" in cols:
            # per-VM Eq. 6 meters: the share of IT energy the jobs drew,
            # against the idle waste a better policy could shed
            row["job_kwh"] = cols["job"][b] / 3.6e6
            row["idle_kwh"] = cols["idle"][b] / 3.6e6
        if "hvac" in cols:
            row["hvac_kwh"] = cols["hvac"][b] / 3.6e6
        rows.append(row)
    return TournamentResult(rows=rows, result=res)
