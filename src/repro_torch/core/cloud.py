"""IaaS service facade (paper §3.5.2): external APIs over the engine state
(port of ``repro.core.cloud``).

Three API families, as in the paper:

* **information retrieval**: :func:`cloud_info` gives the metrics the
  paper lists (running/total PM ratio, hosted VM count, total and running
  capacity, per-PM load, applied schedulers, queue length);
* **virtual-infrastructure management**: requesting and terminating VMs
  is the engine's trace protocol; :func:`repro_torch.core.engine.
  start_migration` covers VM migration;
* **infrastructure alteration**: :func:`deregister_pm` masks a PM out and
  abruptly kills its VMs (the paper's "violent deregistration", used for
  fault injection).

Each function takes one scenario's state: the unbatched ``CloudState`` of
a :class:`~repro_torch.core.engine.CloudResult` (``res.state``), on any
device.  They run on the host side of the simulation, between calls of
``simulate``.
"""
from __future__ import annotations

from typing import Any

import torch

from ..sched import registry as _policy_registry
from . import machine as mc
from .arrays import scatter_drop, segment_sum
from .energy import PM_OFF, PM_RUNNING, meter_readings
from .engine import CloudParams, CloudSpec, CloudState, Trace
from .loop.state import TASK_ACTIVE, TASK_DONE, TASK_PENDING, TASK_REJECTED


def _sched_name(code, layer: str) -> str:
    """The policy name of a host int or 0-d tensor code; a code whose
    policy was unregistered since the params were built gives
    ``"<unregistered>"``."""
    try:
        return _policy_registry.name_of(layer, int(torch.as_tensor(code)))
    except KeyError:
        return "<unregistered>"


def cloud_info(spec: CloudSpec, params: CloudParams, st: CloudState,
               trace: Trace) -> dict[str, Any]:
    """One-time-query information APIs (the §3.5.2 list), as host numbers;
    ``params`` is one scenario's (unbatched) point."""
    P = spec.n_pm
    pm_cores = float(torch.as_tensor(params.pm_cores))
    running = st.pstate == PM_RUNNING
    hosted = st.vstage != mc.VM_FREE
    arrival = torch.as_tensor(trace.arrival, dtype=torch.float32,
                              device=st.t.device)
    queued = (st.task_state == TASK_PENDING) & (arrival <= st.t)
    # the reference's segment sum drops hosts outside [0, P)
    counted = hosted & (st.vm_host >= 0) & (st.vm_host < P)
    per_pm_vms = segment_sum(hosted.to(torch.int32)[None], st.vm_host[None],
                             P, where=counted[None])[0]
    running_cores = torch.where(running, pm_cores, 0.0)
    used = torch.where(running, pm_cores - st.free_cores, 0.0)
    return {
        "t": float(st.t),
        "pm_running_ratio": float(running.sum()) / P,
        "pm_running": int(running.sum()),
        "pm_total": P,
        "vm_hosted": int(hosted.sum()),
        "capacity_total_cores": float(pm_cores * P),
        "capacity_running_cores": float(running_cores.sum()),
        "capacity_allocated_cores": float(used.sum()),
        "pm_load": (used / pm_cores).tolist(),
        "pm_vm_count": per_pm_vms.tolist(),
        "queue_len": int(queued.sum()),
        "vm_scheduler": _sched_name(params.vm_sched, "vm"),
        "pm_scheduler": _sched_name(params.pm_sched, "pm"),
        "tasks_done": int((st.task_state == TASK_DONE).sum()),
        "tasks_rejected": int((st.task_state == TASK_REJECTED).sum()),
        "tasks_active": int((st.task_state == TASK_ACTIVE).sum()),
        "energy_joules": float(st.meters.total.energy),
        # the whole meter stack by name (per PM, per VM Eq. 6, groups,
        # the whole-IaaS aggregate, indirect meters)
        "meters": {
            name: (v.reshape(-1).tolist() if v.dim() else float(v))
            for name, v in meter_readings(spec.meters, st.meters).items()},
    }


def _drop_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` as a scatter with ``mode="drop"`` reads it: a negative index
    counts from the end, and what still lies outside ``[0, n)`` goes to
    the drop slot ``n``."""
    idx = torch.where(idx < 0, idx + n, idx)
    return torch.where((idx >= 0) & (idx < n), idx, n)


def deregister_pm(spec: CloudSpec, params: CloudParams, st: CloudState,
                  pm: int, trace: Trace) -> CloudState:
    """Violently deregister a PM (§3.5.2 infrastructure alteration): its
    VMs end abruptly and their tasks go back to PENDING, so user-side
    schedulers can observe and re-submit them.  The VM-task flows are the
    pool's first ``V`` slots, as in the reference's layout."""
    dev = st.t.device
    pm = torch.as_tensor(pm, dtype=torch.int32, device=dev)
    T, V, P = trace.n, spec.n_vm, spec.n_pm
    victim = (st.vm_host == pm) & (st.vstage != mc.VM_FREE)
    tslot = _drop_index(torch.where(victim, st.vm_task, T).long(), T)[None]
    pslot = _drop_index(pm.long().reshape(1, 1), P)
    pm_cores = torch.as_tensor(params.pm_cores, dtype=torch.float32,
                               device=dev)
    return st._replace(
        task_state=scatter_drop(st.task_state[None], tslot, TASK_PENDING)[0],
        task_vm=scatter_drop(st.task_vm[None], tslot, -1)[0],
        vstage=torch.where(victim, mc.VM_FREE, st.vstage),
        f_active=torch.cat([st.f_active[:V] & ~victim, st.f_active[V:]]),
        pstate=scatter_drop(st.pstate[None], pslot, PM_OFF)[0],
        free_cores=scatter_drop(st.free_cores[None], pslot, pm_cores)[0],
        running=torch.ones((), dtype=torch.bool, device=dev))


def state_change_events(prev: CloudState, cur: CloudState) -> dict[str, Any]:
    """Notification-style differences (§3.6.1): which VMs and PMs changed
    state, and how many tasks completed, between two states."""
    def moves(a, b):
        a, b = a.cpu(), b.cpu()
        return [(int(i), int(a[i]), int(b[i]))
                for i in torch.nonzero(a != b).flatten().tolist()]

    return {
        "vm_transitions": moves(prev.vstage, cur.vstage),
        "pm_transitions": moves(prev.pstate, cur.pstate),
        "tasks_completed": int(((prev.task_state != TASK_DONE)
                                & (cur.task_state == TASK_DONE)).sum()),
    }
