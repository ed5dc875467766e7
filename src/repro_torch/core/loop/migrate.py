"""The shared masked live-migration primitive (paper Fig. 6: running ->
migrating -> resume on the new host), port of ``repro.core.loop.migrate``.

One implementation of "begin live-migrating VM ``v`` to PM ``dst``" for
every caller: the out-of-loop :func:`repro_torch.core.engine.start_migration`
and the migrating PM policies of :mod:`repro_torch.sched.policies`.  Cores
move src -> dst at once (allocation semantics); the VM's flow slot becomes
its serialized memory state moving over the source NIC.  A refused move
(``ok`` False) leaves every tensor bit for bit as it was.

Indices and masks stay on the device: ``v``, ``dst`` and ``ok`` are
tensors, each write selects through a one-hot mask into a new tensor, and
nothing is read back to the host.
"""
from __future__ import annotations

import torch

from .. import machine as mc
from .state import BIG, KIND_MIGRATE, CloudState


def _index(x, device) -> torch.Tensor:
    """``x`` (a number or a tensor of one element) as an int64 [1] tensor."""
    return torch.as_tensor(x, device=device).reshape(1).long()


def migrate_one(spec, params, st: CloudState, v, dst, ok) -> CloudState:
    """Begin live-migrating VM slot ``v`` to PM ``dst``, masked by ``ok``.

    Feasibility is re-checked here (the VM must be RUNNING and the
    destination must have the cores free), so callers may pass optimistic
    masks: an infeasible move is a bitwise no-op."""
    lay = spec.layout
    P, V = spec.n_pm, spec.n_vm
    dev = st.vm_host.device
    v = _index(v, dev)
    dst = _index(dst, dev)
    src = st.vm_host[v].long()
    cores = st.vm_cores[v]
    ok = (torch.as_tensor(ok, device=dev).reshape(1)
          & (st.vstage[v] == mc.VM_RUNNING) & (st.free_cores[dst] >= cores))
    flow = torch.arange(V + P, device=dev)
    on_v = (flow == v) & ok           # [V + P]; the VM slots lead the flows
    on_vm = on_v[:V]

    def w(arr, val):
        mask = on_vm if arr.shape[0] == V else on_v
        return torch.where(mask, val, arr)

    pm = flow[:P]
    # the source gains the cores first, the destination loses them second
    free = torch.where(pm == src,
                       st.free_cores + torch.where(ok, cores, 0.0),
                       st.free_cores)
    free = torch.where(pm == dst, free + torch.where(ok, -cores, 0.0), free)
    return st._replace(
        vstage=w(st.vstage, mc.VM_MIGRATING),
        vm_mig_dst=w(st.vm_mig_dst, dst.to(st.vm_mig_dst.dtype)),
        vm_saved_pr=w(st.vm_saved_pr, st.f_pr[v]),
        free_cores=free,
        f_pr=w(st.f_pr, params.vm_mem_mb),
        f_total=w(st.f_total, params.vm_mem_mb),
        f_pl=w(st.f_pl, BIG),
        f_prov=w(st.f_prov, (lay.netout0 + src).to(st.f_prov.dtype)),
        f_cons=w(st.f_cons, (lay.netin0 + dst).to(st.f_cons.dtype)),
        f_active=w(st.f_active, True),
        f_release=w(st.f_release, st.t + params.latency_s),
        f_kind=w(st.f_kind, KIND_MIGRATE),
        running=st.running | ok[0],
    )


def migrate_many(spec, params, st: CloudState, vs, dsts, ok) -> CloudState:
    """Up to ``K = len(vs)`` masked moves through :func:`migrate_one`, one
    after another, so later moves see the ``free_cores`` that earlier moves
    committed: K moves into one destination cannot overcommit it even when
    the caller's plan was optimistic.  (The reference scans over the moves;
    here K is a host number and the loop is K device steps.)"""
    vs, dsts, ok = (x.reshape(-1) for x in (vs, dsts, ok))
    for k in range(vs.shape[0]):
        st = migrate_one(spec, params, st, vs[k:k + 1], dsts[k:k + 1],
                         ok[k:k + 1])
    return st
