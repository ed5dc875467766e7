"""Stage 6 — ``vm_sched``: the VM scheduler policy hook (port of
``repro.core.loop.vm_sched``).

The stage calls the policy that ``params.vm_sched`` names in the registry.
What stays here is the machinery the builtin dispatchers share:
:func:`serve_queue`, which serves the request queue until blocked or empty.
The reference runs it as a ``lax.while_loop``; the port loops on the host
and reads two flags per dispatching round ("any request queued", "did the
round make progress").

State delta: per dispatched request, the allocated VM slot, its
image-transfer flow, the host's ``free_cores`` and the task binding; per
rejected request, its ``task_state``.
"""
from __future__ import annotations

import math

import torch

from ...sched import registry
from .. import machine as mc
from ..arrays import KIND_IMAGE_XFER
from .state import BIG, TASK_ACTIVE, TASK_PENDING, TASK_REJECTED, CloudState, StageCtx


def _set_at(arr: torch.Tensor, i: torch.Tensor, do: torch.Tensor, val):
    """``arr.at[i].set(where(do, val, arr[i]))`` without a host read."""
    out = arr.clone()
    new = torch.where(do, torch.as_tensor(val, dtype=arr.dtype,
                                          device=arr.device), arr[i])
    out.index_put_((i.reshape(1),), new.reshape(1))
    return out


def serve_queue(spec, params, trace, st: CloudState, *,
                smallest_first: bool = False,
                reject_unfit: bool = False) -> CloudState:
    """Serve the request queue until blocked or empty.

    ``smallest_first`` orders the queue by requested cores instead of
    arrival time; ``reject_unfit`` rejects a head request no running host
    can currently fit (the paper's non-queuing cloud).  Oversized requests
    (larger than one PM) are always rejected.  Ties break on the first
    index, as the reference's ``argmin``/``argmax`` do.
    """
    lay = spec.layout
    qkey = trace.cores if smallest_first else trace.arrival
    t0 = st.t
    release = t0 + params.latency_s
    while True:
        queued = (st.task_state == TASK_PENDING) & (trace.arrival <= t0)
        any_q = queued.any()
        if not bool(any_q):
            # an empty queue makes the round an exact no-op that ends the loop
            break
        key = torch.where(queued, qkey, math.inf)
        head = torch.argmin(key)
        h_cores = trace.cores[head]

        oversize = h_cores > params.pm_cores
        fit = mc.pm_accepting(st.pstate) & (st.free_cores >= h_cores)
        any_fit = fit.any()
        pm = torch.argmax(fit.to(torch.uint8))
        vfree = st.vstage == mc.VM_FREE
        any_v = vfree.any()
        v = torch.argmax(vfree.to(torch.uint8))

        blocked = oversize | ~any_fit if reject_unfit else oversize
        do_reject = any_q & blocked
        do_dispatch = any_q & ~do_reject & any_fit & any_v
        overflow = any_q & ~do_reject & any_fit & ~any_v

        task_state = _set_at(st.task_state, head, do_reject, TASK_REJECTED)
        pm32 = pm.to(torch.int32)

        def wv(arr, val):
            return _set_at(arr, v, do_dispatch, val)

        st = st._replace(
            task_state=_set_at(task_state, head, do_dispatch, TASK_ACTIVE),
            task_vm=_set_at(st.task_vm, head, do_dispatch, v.to(torch.int32)),
            vstage=wv(st.vstage, mc.VM_INITIAL_TRANSFER),
            vm_task=wv(st.vm_task, head.to(torch.int32)),
            vm_host=wv(st.vm_host, pm32),
            vm_cores=wv(st.vm_cores, h_cores),
            vm_expiry=wv(st.vm_expiry, math.inf),
            free_cores=st.free_cores.index_add(
                0, pm.reshape(1),
                torch.where(do_dispatch, -h_cores, 0.0).reshape(1)),
            f_pr=wv(st.f_pr, params.image_mb),
            f_total=wv(st.f_total, params.image_mb),
            f_pl=wv(st.f_pl, BIG),
            f_prov=wv(st.f_prov, lay.repo_out),
            f_cons=wv(st.f_cons, lay.netin0 + pm32),
            f_active=wv(st.f_active, True),
            f_release=wv(st.f_release, release),
            f_kind=wv(st.f_kind, KIND_IMAGE_XFER),
            overflow=st.overflow | overflow,
        )
        if not bool(do_dispatch | do_reject):
            break
    return st


def vm_sched(ctx: StageCtx, st: CloudState):
    policy = registry.get("vm", ctx.params.vm_sched)
    return ctx, policy.fn(ctx.spec, ctx.params, ctx, st)
