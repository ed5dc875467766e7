"""The shared masked live-migration primitive (paper Fig. 6: running ->
migrating -> resume on the new host), port of ``repro.core.loop.migrate``.

One implementation of "begin live-migrating VM ``v`` to PM ``dst``" for
every caller: the out-of-loop :func:`repro_torch.core.engine.start_migration`
and the migrating PM policies of :mod:`repro_torch.sched.policies`.  Cores
move src -> dst at once (allocation semantics); the VM's flow slot becomes
its serialized memory state moving over the source NIC.  A refused move
(``ok`` False) leaves every tensor bit for bit as it was.

Indices and masks stay on the device: ``v``, ``dst`` and ``ok`` are
tensors, one entry a lane ([B]), each write selects through a one-hot mask
into a new tensor, and nothing is read back to the host.
"""
from __future__ import annotations

import torch

from .. import machine as mc
from .state import BIG, KIND_MIGRATE, CloudState


def migrate_one(spec, params, st: CloudState, v, dst, ok) -> CloudState:
    """Begin live-migrating VM slot ``v`` to PM ``dst`` in each lane, masked
    by ``ok`` (each [B], or [B, 1]).

    Feasibility is re-checked here (the VM must be RUNNING and the
    destination must have the cores free), so callers may pass optimistic
    masks: an infeasible move is a bitwise no-op."""
    lay = spec.layout
    B, V = st.vm_host.shape
    P = spec.n_pm
    dev = st.vm_host.device
    v = v.reshape(B, 1).long()
    dst = dst.reshape(B, 1).long()
    src = st.vm_host.gather(1, v).long()
    cores = st.vm_cores.gather(1, v)
    ok = (ok.reshape(B, 1) & (st.vstage.gather(1, v) == mc.VM_RUNNING)
          & (st.free_cores.gather(1, dst) >= cores))
    flow = torch.arange(V + P, device=dev)
    on_v = (flow == v) & ok           # [B, V + P]; the VM slots lead the flows
    on_vm = on_v[:, :V]

    def w(arr, val):
        mask = on_vm if arr.shape[1] == V else on_v
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
        vm_saved_pr=w(st.vm_saved_pr, st.f_pr.gather(1, v)),
        free_cores=free,
        f_pr=w(st.f_pr, params.vm_mem_mb[:, None]),
        f_total=w(st.f_total, params.vm_mem_mb[:, None]),
        f_pl=w(st.f_pl, BIG),
        f_prov=w(st.f_prov, (lay.netout0 + src).to(st.f_prov.dtype)),
        f_cons=w(st.f_cons, (lay.netin0 + dst).to(st.f_cons.dtype)),
        f_active=w(st.f_active, True),
        f_release=w(st.f_release, (st.t + params.latency_s)[:, None]),
        f_kind=w(st.f_kind, KIND_MIGRATE),
        running=st.running | ok[:, 0],
    )


def migrate_many(spec, params, st: CloudState, vs, dsts, ok) -> CloudState:
    """Up to ``K`` masked moves a lane (``vs``, ``dsts``, ``ok`` [B, K])
    through :func:`migrate_one`, one after another, so later moves see the
    ``free_cores`` that earlier moves committed: K moves into one
    destination cannot overcommit it even when the caller's plan was
    optimistic.  (The reference scans over the moves; here K is a host
    number and the loop is K device steps.)"""
    for k in range(vs.shape[1]):
        st = migrate_one(spec, params, st, vs[:, k], dsts[:, k], ok[:, k])
    return st
