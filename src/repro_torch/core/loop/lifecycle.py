"""Stage 3 — ``vm_lifecycle``: the Fig. 6 VM state machine (port of
``repro.core.loop.lifecycle``).

Every flow completion reported by ``advance`` moves its VM slot along the
lifecycle by rewriting the slot's single consumption in place: image
transfer -> boot work -> the user task -> destroy, plus the migration
arrival and the §3.4.2 allocation-expiry self-defence.

The reference skips the body behind an event gate (no VM-flow completion
and no expiry).  The port runs it every pass: with the gate False every
write selects the old value and ``free_cores`` gains an exact ``+0.0``, so
the body is bitwise identity and the gate needs no host read.
"""
from __future__ import annotations

import torch

from .. import machine as mc
from ..arrays import KIND_BOOT, KIND_IMAGE_XFER, KIND_TASK, scatter_drop, segment_sum
from .state import BIG, KIND_MIGRATE, TASK_DONE, CloudState, StageCtx


def vm_lifecycle(ctx: StageCtx, st: CloudState):
    spec, params, trace = ctx.spec, ctx.params, ctx.trace
    lay = spec.layout
    P, V, T = spec.n_pm, spec.n_vm, trace.n
    vm_slot = torch.arange(V, dtype=torch.int32, device=st.vm_host.device)
    t_new = ctx.t_new

    # Work on the VM-flow prefix [:V]; the hidden-consumer suffix belongs
    # to the pm_power stage.
    vdone = ctx.done[:V]
    kind = st.f_kind[:V]
    host = st.vm_host
    xfer_done = vdone & (kind == KIND_IMAGE_XFER)
    boot_done = vdone & (kind == KIND_BOOT)
    task_done = vdone & (kind == KIND_TASK)
    mig_done = vdone & (kind == KIND_MIGRATE)

    v_pr, v_total = st.f_pr[:V], st.f_total[:V]
    v_pl, v_kind = st.f_pl[:V], st.f_kind[:V]
    v_prov, v_cons = st.f_prov[:V], st.f_cons[:V]
    v_release, v_active = st.f_release[:V], st.f_active[:V]

    # image transfer -> startup: flow becomes boot work on the host CPU
    v_pr = torch.where(xfer_done, params.boot_work, v_pr)
    v_total = torch.where(xfer_done, params.boot_work, v_total)
    v_prov = torch.where(xfer_done | boot_done, lay.cpu0 + host, v_prov)
    v_cons = torch.where(xfer_done | boot_done, lay.vm0 + vm_slot, v_cons)
    v_pl = torch.where(xfer_done, BIG, v_pl)
    v_kind = torch.where(xfer_done, KIND_BOOT, v_kind)
    v_release = torch.where(xfer_done | boot_done | mig_done, t_new,
                            v_release)
    vstage = torch.where(xfer_done, mc.VM_STARTUP, st.vstage)

    # boot -> running: flow becomes the user task
    tid = torch.clamp_min(st.vm_task, 0).long()
    twork = trace.work[tid]
    tcores = trace.cores[tid]
    v_pr = torch.where(boot_done, twork, v_pr)
    v_total = torch.where(boot_done, twork, v_total)
    v_pl = torch.where(boot_done, tcores * params.perf_core, v_pl)
    v_kind = torch.where(boot_done, KIND_TASK, v_kind)
    vstage = torch.where(boot_done, mc.VM_RUNNING, vstage)

    # migration arrives: resume the task on the destination host
    new_host = torch.where(mig_done, st.vm_mig_dst, host)
    v_pr = torch.where(mig_done, st.vm_saved_pr, v_pr)
    v_total = torch.where(mig_done, torch.clamp_min(st.vm_saved_pr, 1e-9),
                          v_total)
    v_pl = torch.where(mig_done, tcores * params.perf_core, v_pl)
    v_kind = torch.where(mig_done, KIND_TASK, v_kind)
    v_prov = torch.where(mig_done, lay.cpu0 + new_host, v_prov)
    v_cons = torch.where(mig_done, lay.vm0 + vm_slot, v_cons)
    vstage = torch.where(mig_done, mc.VM_RUNNING, vstage)

    # task done -> destroy VM, release cores, complete task; cores freed by
    # completion and by allocation expiry share one 2-column reduction
    expired = (st.vstage == mc.VM_ALLOCATED) & (st.vm_expiry <= t_new)
    freed = segment_sum(
        torch.stack([torch.where(task_done, st.vm_cores, 0.0),
                     torch.where(expired, st.vm_cores, 0.0)], dim=-1),
        host, P, where=task_done | expired)
    free_cores = st.free_cores + freed[:, 0]
    tslot = torch.where(task_done, st.vm_task, T)     # T = scatter drop
    task_state = scatter_drop(st.task_state, tslot, TASK_DONE)
    t_done = scatter_drop(st.t_done, tslot, t_new.expand(V))
    vstage = torch.where(task_done, mc.VM_FREE, vstage)
    v_active = torch.where(task_done, False, v_active)

    def prefix(full, head):
        return torch.cat([head, full[V:]])

    # allocation expiry (§3.4.2 self-defence)
    free_cores = free_cores + freed[:, 1]
    vstage = torch.where(expired, mc.VM_FREE, vstage)

    return ctx, st._replace(
        f_pr=prefix(st.f_pr, v_pr), f_total=prefix(st.f_total, v_total),
        f_pl=prefix(st.f_pl, v_pl), f_prov=prefix(st.f_prov, v_prov),
        f_cons=prefix(st.f_cons, v_cons),
        f_release=prefix(st.f_release, v_release),
        f_kind=prefix(st.f_kind, v_kind),
        f_active=prefix(st.f_active, v_active),
        task_state=task_state, t_done=t_done,
        vstage=vstage, vm_host=new_host, free_cores=free_cores)
