"""The paper's baseline policies (§3.5.1), as registry citizens (port of
``repro.sched.policies.baseline``).

PM layer: ``alwayson`` (the identity) and ``ondemand`` (wake enough
machines for the unmet queue, switch off loadless machines when the queue
is empty).  VM layer: ``firstfit`` / ``nonqueuing`` / ``smallestfirst``,
configurations of :func:`repro_torch.core.loop.vm_sched.serve_queue`.
"""
from __future__ import annotations

import math

import torch

from ...core import machine as mc
from ...core.arrays import KIND_HIDDEN, lane_sum, segment_sum
from ...core.energy import PM_OFF, PM_RUNNING, PM_SWITCHING_OFF, PM_SWITCHING_ON
from ...core.loop.state import TASK_PENDING, CloudState
from ...core.loop.vm_sched import serve_queue
from .. import registry

# --------------------------------------------------------------- PM layer


def _hosted_per_pm(spec, st: CloudState) -> torch.Tensor:
    return segment_sum((st.vstage != mc.VM_FREE).to(torch.int32),
                       st.vm_host, spec.n_pm)


def wake_sleep_pass(spec, params, trace, st: CloudState) -> CloudState:
    """On-demand's wake/sleep rules: wake enough OFF machines to cover the
    queued core deficit; switch off loadless RUNNING machines when nothing
    is queued.  Under the complex power model the transition work becomes
    the machine's hidden-consumer flow (paper Table 2)."""
    P = spec.n_pm
    table = params.power
    t = st.t[:, None]
    queued = (st.task_state == TASK_PENDING) & (trace.arrival <= t)
    # each lane summed alone: the wake count must not hang on the lane count
    q_cores = lane_sum(torch.where(queued, trace.cores, 0.0))
    soon = mc.pm_future_capacity(st.pstate)
    cap_soon = lane_sum(torch.where(soon, st.free_cores, 0.0))
    deficit = q_cores - cap_soon
    k = torch.ceil(torch.clamp_min(deficit, 0.0) / params.pm_cores).to(
        torch.int32)

    off = st.pstate == PM_OFF
    wake = off & (torch.cumsum(off.to(torch.int32), 1) <= k[:, None])
    idle = ((st.pstate == PM_RUNNING) & (_hosted_per_pm(spec, st) == 0)
            & ~queued.any(-1, keepdim=True))

    boot_s = table.duration[:, PM_SWITCHING_ON:PM_SWITCHING_ON + 1]
    halt_s = table.duration[:, PM_SWITCHING_OFF:PM_SWITCHING_OFF + 1]
    pstate = torch.where(wake, PM_SWITCHING_ON, st.pstate)
    pstate = torch.where(idle, PM_SWITCHING_OFF, pstate)
    pstate_end = torch.where(wake, t + boot_s, st.pstate_end)
    pstate_end = torch.where(idle, t + halt_s, pstate_end)
    st = st._replace(pstate=pstate, pstate_end=pstate_end)

    if spec.complex_power:
        # the hidden consumer carries the transition work; the transition
        # ends when the hidden flow drains (pstate_end stays at +inf)
        lay = spec.layout
        V = spec.n_vm
        dev = st.pstate.device
        pm = torch.arange(P, dtype=torch.int32, device=dev)
        trans = wake | idle
        amount = torch.where(wake, params.hidden_work_on[:, None],
                             params.hidden_work_off[:, None])

        def hid(field, value):
            return torch.cat([field[:, :V],
                              torch.where(trans, value, field[:, V:])], dim=1)

        st = st._replace(
            pstate_end=torch.where(trans, math.inf, pstate_end),
            f_pr=hid(st.f_pr, amount),
            f_total=hid(st.f_total, amount),
            f_pl=hid(st.f_pl, (0.2 * params.pm_cores)[:, None]),
            f_prov=hid(st.f_prov, lay.cpu0 + pm),
            f_cons=hid(st.f_cons, lay.hidden0 + pm),
            f_active=hid(st.f_active, True),
            f_release=hid(st.f_release, t),
            f_kind=hid(st.f_kind, KIND_HIDDEN),
        )
    return st


def alwayson(spec, params, ctx, st: CloudState) -> CloudState:
    """Machines keep whatever power state they have (paper baseline)."""
    return st


def ondemand(spec, params, ctx, st: CloudState) -> CloudState:
    return wake_sleep_pass(spec, params, ctx.trace, st)


# --- event-gate triggers: necessary conditions for each policy to act


def _queued_any(spec, params, ctx, st):
    return ((st.task_state == TASK_PENDING)
            & (ctx.trace.arrival <= st.t[:, None])).any(-1)


def _never(spec, params, ctx, st):
    return torch.zeros(st.t.shape, dtype=torch.bool, device=st.t.device)


def _wake_sleep_trigger(spec, params, ctx, st):
    queued = ((st.task_state == TASK_PENDING)
              & (ctx.trace.arrival <= st.t[:, None]))
    loadless = (st.pstate == PM_RUNNING) & (_hosted_per_pm(spec, st) == 0)
    return queued.any(-1) | loadless.any(-1)


FLOW_FIELDS = ("f_pr", "f_total", "f_pl", "f_prov", "f_cons", "f_active",
               "f_release", "f_kind")
WAKE_SLEEP_DELTA = ("pstate", "pstate_end") + FLOW_FIELDS

registry.register(
    "pm", "alwayson", alwayson, code=0, starts_running=True, trigger=_never,
    doc="identity: the whole fleet stays powered on")
registry.register(
    "pm", "ondemand", ondemand, code=1, requires=WAKE_SLEEP_DELTA,
    trigger=_wake_sleep_trigger,
    doc="wake machines against the queued core deficit, sleep loadless ones")

# --------------------------------------------------------------- VM layer


def firstfit(spec, params, ctx, st: CloudState) -> CloudState:
    return serve_queue(spec, params, ctx.trace, st)


def nonqueuing(spec, params, ctx, st: CloudState) -> CloudState:
    return serve_queue(spec, params, ctx.trace, st, reject_unfit=True)


def smallestfirst(spec, params, ctx, st: CloudState) -> CloudState:
    return serve_queue(spec, params, ctx.trace, st, smallest_first=True)


DISPATCH_DELTA = ("task_state", "task_vm", "vstage", "vm_task", "vm_host",
                  "vm_cores", "vm_expiry", "free_cores",
                  "overflow") + FLOW_FIELDS

registry.register(
    "vm", "firstfit", firstfit, code=0, requires=DISPATCH_DELTA,
    trigger=_queued_any,
    doc="arrival-ordered queue, first running host with the cores free")
registry.register(
    "vm", "nonqueuing", nonqueuing, code=1, requires=DISPATCH_DELTA,
    trigger=_queued_any,
    doc="first-fit, but a request that cannot start now is rejected")
registry.register(
    "vm", "smallestfirst", smallestfirst, code=2, requires=DISPATCH_DELTA,
    trigger=_queued_any,
    doc="serve the smallest queued task first (backfilling flavour)")
