"""Stage 2 — ``observe``: the metering hook over ``[t0, t_new]`` (port of
the dense path of ``repro.core.loop.observe``).

Builds one :class:`~repro_torch.core.energy.SimView` of the interval from
interval-start facts (``ctx.r``/``ctx.live``/``ctx.delivered``, clock
``ctx.t0``) and calls :func:`repro_torch.core.energy.observe`.

State delta: ``meters``.  Context delta: ``view``.
"""
from __future__ import annotations

import torch

from .. import machine as mc
from ..energy import MODEL_LINEAR, SimView, instantaneous_power, observe
from ..influence import coupled_vm_counts, influence_labels
from .state import TASK_PENDING, CloudState, StageCtx


def _eq6_views(ctx: StageCtx, st: CloudState, cpu_del: torch.Tensor):
    """(vm_rate_frac, vm_host, vms_on_host) — Eq. 6 group membership via the
    influence components."""
    spec = ctx.spec
    lay = spec.layout
    P, V = spec.n_pm, spec.n_vm
    labels = influence_labels(st.f_prov, st.f_cons, ctx.live, lay.S)
    vm_spreader = lay.vm0 + torch.arange(V, dtype=torch.int32,
                                         device=st.vm_host.device)
    in_grp, vms_on_host = coupled_vm_counts(
        labels, lay.cpu0 + st.vm_host, vm_spreader, st.vm_host, P)
    vm_rate_frac = (torch.where(in_grp, ctx.r[:V], 0.0)
                    / torch.clamp_min(cpu_del[st.vm_host.long()], 1e-30))
    vm_host = torch.where(in_grp, st.vm_host, -1)
    return vm_rate_frac, vm_host, vms_on_host


def build_view(ctx: StageCtx, st: CloudState) -> SimView:
    """The meter stack's observation surface for the current interval."""
    spec, params, trace = ctx.spec, ctx.params, ctx.trace
    lay = spec.layout
    P, V = spec.n_pm, spec.n_vm
    table = params.power
    dev = st.pstate.device

    cpu_del = ctx.delivered[lay.cpu0:lay.cpu0 + P]
    cpu_cap = max(params.pm_cores * params.perf_core, 1e-30)
    util = cpu_del / cpu_cap
    power = instantaneous_power(table, st.pstate, util)
    ps = st.pstate.long()
    p_idle = table.p_min[ps]
    p_span = torch.where(table.mode[ps] == MODEL_LINEAR,
                         table.p_max[ps] - p_idle, 0.0)

    if spec.meters.vm_direct:
        vm_rate_frac, vm_host, vms_on_host = _eq6_views(ctx, st, cpu_del)
    else:
        vms_on_host = torch.zeros((P,), dtype=torch.int32, device=dev)
        vm_rate_frac = torch.zeros((V,), dtype=torch.float32, device=dev)
        vm_host = torch.full((V,), -1, dtype=torch.int32, device=dev)

    hosted = st.vstage != mc.VM_FREE
    queued = (st.task_state == TASK_PENDING) & (trace.arrival <= ctx.t0)
    return SimView(
        pm_power=power, pm_idle=p_idle, pm_span=p_span, pm_util=util,
        vm_rate_frac=vm_rate_frac, vm_host=vm_host, vms_on_host=vms_on_host,
        n_hosted=hosted.sum().to(torch.float32),
        n_queued=queued.sum().to(torch.float32),
        tick=ctx.tick, period=ctx.period)


def observe_stage(ctx: StageCtx, st: CloudState):
    view = build_view(ctx, st)
    meters = observe(ctx.spec.meters, ctx.params.meter, view, ctx.dt,
                     st.meters)
    return ctx._replace(view=view), st._replace(meters=meters)
