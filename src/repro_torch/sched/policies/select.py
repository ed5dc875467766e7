"""Shared source and victim selection for the migrating PM policies (port
of ``repro.sched.policies.select``).

Consolidation, defragmentation and evacuation reason over the same host
facts (who is RUNNING, how loaded, who hosts migratable VMs), and the
first and last share the idle-dominance trigger: one implementation here,
so a trigger or a tie-break cannot drift between the policies.

Every choice is a device tensor of one element a lane ([B, 1]: ``argmin``
/ ``argmax`` along the lane's row with ``keepdim``, first extreme index on
ties as in the reference, index 0 when every entry is ``±inf``), so
nothing is read back to the host.
"""
from __future__ import annotations

import torch

from ...core import machine as mc
from ...core.arrays import segment_sum
from ...core.energy import PM_RUNNING
from ...core.loop.state import CloudState

INF = float("inf")


def host_load_facts(spec, params, st: CloudState):
    """``(running, used, movable, n_movable)``: per-PM RUNNING mask and
    allocated cores, per-VM migratable (RUNNING) mask, per-PM migratable
    counts."""
    running = st.pstate == PM_RUNNING
    used = params.pm_cores[:, None] - st.free_cores
    movable = st.vstage == mc.VM_RUNNING
    n_movable = segment_sum(movable.to(torch.int32), st.vm_host, spec.n_pm)
    return running, used, movable, n_movable


def idle_dominated_donor(params, st: CloudState, running, used, n_movable):
    """``(donor, src)``: the donor mask — RUNNING hosts with a migratable
    VM whose live meter reading is idle-dominated (``pm_idle.last_power /
    pm.last_power`` above ``CloudParams.consolidate_idle_frac``) — and the
    least-loaded such host as the source."""
    pm_w = st.meters.pm.last_power
    idle_w = st.meters.pm_idle.last_power
    idle_frac = idle_w / torch.clamp_min(pm_w, 1e-30)
    # the reference compares against the threshold rounded to f32, as the
    # lane's f32 parameter holds it
    frac = params.consolidate_idle_frac[:, None]
    donor = running & (n_movable > 0) & (idle_frac > frac)
    src = torch.argmin(torch.where(donor, used, INF), dim=-1, keepdim=True)
    return donor, src


def feasible_destinations(running, used, free_cores, src, need):
    """Hosts a victim of ``need`` cores may move to: RUNNING, the cores
    free, not the source, and at least as loaded as the source — the
    load-ordering guard that makes every move packing (never spreading)
    and stops ping-pong between two equally loaded hosts."""
    P = running.shape[-1]
    return (running & (free_cores >= need)
            & (torch.arange(P, device=running.device) != src)
            & (used >= used.gather(1, src)))


def smallest_victim_on(st: CloudState, movable, src):
    """``(on_src, v)``: the source host's migratable VMs and the
    smallest-cores one (the cheapest serialized state to re-place)."""
    on_src = movable & (st.vm_host == src)
    v = torch.argmin(torch.where(on_src, st.vm_cores, INF), dim=-1,
                     keepdim=True)
    return on_src, v
