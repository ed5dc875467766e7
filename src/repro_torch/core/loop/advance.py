"""Stage 1 — ``advance``: unified resource sharing + clock-to-horizon
(port of the dense path of ``repro.core.loop.advance``).

Computes the per-spreader performance vector (Eq. 5), runs the sharing
scheduler (§3.2) for this interval's rates, finds the event horizon ``dt``
with the :func:`~repro_torch.kernels.horizon.masked_min` kernel (§3.1),
advances the Kahan clock by exactly ``dt`` and drains every live flow.
The horizon stays a device scalar: nothing here reads it back to the host.

State delta: ``t``/``t_c``/``n_events``, ``meter_next``, ``f_pr``,
``processed``.  Context delta: ``r``, ``live``, ``thresh``, ``done``,
``delivered``, ``dt``, ``t0``/``t_new``, ``has_event``, ``tick``,
``period``.
"""
from __future__ import annotations

import torch

from ...kernels.horizon import masked_min
from .. import machine as mc
from ..arrays import segment_sum
from ..energy import PM_OFF, PM_RUNNING, PM_SWITCHING_OFF, PM_SWITCHING_ON, kahan_add
from ..fairshare import SCHEDULERS
from .state import BIG, CloudState, StageCtx, live_threshold


def spreader_perf(spec, params, st: CloudState) -> torch.Tensor:
    """perf[S] from machine states (Eq. 5: power state gates processing)."""
    P = spec.n_pm
    dev = st.pstate.device
    cpu_cap = params.pm_cores * params.perf_core
    cpu_on = st.pstate == PM_RUNNING
    if spec.complex_power:
        cpu_on = cpu_on | (st.pstate == PM_SWITCHING_ON) | (
            st.pstate == PM_SWITCHING_OFF)
    net_on = st.pstate != PM_OFF
    net = torch.where(net_on, params.net_bw, 0.0)
    vm_on = mc.vm_cpu_active(st.vstage) | (st.vstage == mc.VM_INITIAL_TRANSFER)
    return torch.cat([
        torch.where(cpu_on, cpu_cap, 0.0),                       # cpu
        net, net,                                                # net in/out
        torch.full((2,), params.repo_bw, dtype=torch.float32,
                   device=dev),                                  # repo
        torch.where(vm_on, torch.clamp_min(st.vm_cores, 1.0)
                    * params.perf_core, 0.0),                    # vm cpu
        torch.full((P,), cpu_cap, dtype=torch.float32, device=dev),  # hidden
    ]).to(torch.float32)


def advance(ctx: StageCtx, st: CloudState):
    spec, params, trace = ctx.spec, ctx.params, ctx.trace
    lay = spec.layout
    T = trace.n
    thresh = live_threshold(st.f_total)
    live = st.f_active & (st.t >= st.f_release) & (st.f_pr > thresh)
    rate_fn = SCHEDULERS[spec.scheduler]

    perf = spreader_perf(spec, params, st)
    r = rate_fn(st.f_prov, st.f_cons, st.f_pl, live, perf,
                max_iters=spec.max_fill_iters)
    flow_cand = [st.f_pr / torch.clamp_min(r, 1e-30),    # completion   [F]
                 st.f_release - st.t]                    # latency      [F]
    flow_mask = [live & (r > 0), st.f_active & (st.t < st.f_release)]

    # ---- event horizon: one masked-min reduction ------------------------
    # Families: flow completion, latency-gate release, PM power transition,
    # and the scalar tail (allocation expiry pre-reduced, meter tick,
    # t_stop, next arrival from the presorted arrival vector).
    trans = (st.pstate == PM_SWITCHING_ON) | (st.pstate == PM_SWITCHING_OFF)
    exp_min = torch.min(torch.where(
        (st.vstage == mc.VM_ALLOCATED) & torch.isfinite(st.vm_expiry),
        st.vm_expiry - st.t, BIG))
    true = torch.ones((), dtype=torch.bool, device=st.t.device)
    tail_cand = [exp_min, st.meter_next - st.t, ctx.t_stop - st.t]
    tail_mask = [true, torch.isfinite(st.meter_next),
                 torch.isfinite(ctx.t_stop)]
    # The clock is monotone and dispatch requires arrival <= t, so every
    # strictly-future arrival belongs to a PENDING task and the family's
    # minimum is the first sorted arrival past t.
    nxt = torch.searchsorted(ctx.arrival_sorted, st.t.reshape(1),
                             right=True)[0]
    tail_cand.append(ctx.arrival_sorted[torch.clamp_max(nxt, T - 1)] - st.t)
    tail_mask.append(nxt < T)
    cand = torch.cat(flow_cand + [st.pstate_end - st.t,
                                  torch.stack(tail_cand)])
    mask = torch.cat(flow_mask + [trans & torch.isfinite(st.pstate_end),
                                  torch.stack(tail_mask)])
    dt = masked_min(cand, mask)
    has_event = dt < BIG
    dt = torch.where(has_event, torch.clamp_min(dt, 0.0), 0.0)

    # ---- clock + sampled-meter tick ------------------------------------
    t_new, t_c = kahan_add(st.t, st.t_c, dt)
    tick = torch.isfinite(st.meter_next) & (st.meter_next <= t_new)
    period = torch.tensor(params.metering_period, dtype=torch.float32,
                          device=st.t.device)
    meter_next = torch.where(tick, st.meter_next + period, st.meter_next)

    # ---- drain flows ----------------------------------------------------
    f_pr = torch.where(live, torch.clamp_min(st.f_pr - r * dt, 0.0), st.f_pr)
    done = live & (f_pr <= thresh)
    # one 2-column provider-side reduction: delivered rate (observe's
    # utilisation numerator) and processed work
    prov_stats = segment_sum(
        torch.stack([torch.where(live, r, 0.0),
                     torch.where(live, r * dt, 0.0)], dim=-1),
        st.f_prov, lay.S, where=live)
    delivered = prov_stats[:, 0]
    processed = st.processed + prov_stats[:, 1]

    ctx = ctx._replace(r=r, live=live, thresh=thresh, done=done,
                       delivered=delivered, dt=dt, t0=st.t, t_new=t_new,
                       has_event=has_event, tick=tick, period=period)
    st = st._replace(t=t_new, t_c=t_c, n_events=st.n_events + 1,
                     meter_next=meter_next, f_pr=f_pr, processed=processed)
    return ctx, st
