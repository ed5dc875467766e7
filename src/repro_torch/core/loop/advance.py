"""Stage 1 — ``advance``: unified resource sharing + clock-to-horizon
(port of ``repro.core.loop.advance``).

Computes the per-spreader performance vector (Eq. 5), runs the sharing
scheduler (§3.2) for this interval's rates, finds the event horizon ``dt``
with the :func:`~repro_torch.kernels.horizon.masked_min` kernel (§3.1),
advances the Kahan clock by exactly ``dt`` and drains every live flow.
The horizon stays on the device, one value a lane: nothing here reads it
back to the host.

With active-set compaction on (:mod:`repro_torch.core.loop.compact`) the
fair-share solve, the flow lanes of the horizon and the provider
reduction run over the active-flow bucket and scatter back, bit-identical
to the dense pass; the Eq. 5 vector stays dense and the bucket gathers
from it.

State delta: ``t``/``t_c``/``n_events``, ``meter_next``, ``f_pr``,
``processed``.  Context delta: ``r``, ``live``, ``thresh``, ``done``,
``delivered``, ``dt``, ``t0``/``t_new``, ``has_event``, ``tick``,
``period``, ``compact``.
"""
from __future__ import annotations

import torch

from ...kernels.horizon import masked_min
from .. import machine as mc
from ..arrays import scatter_drop, segment_sum
from ..energy import PM_OFF, PM_RUNNING, PM_SWITCHING_OFF, PM_SWITCHING_ON, kahan_add
from ..fairshare import SCHEDULERS
from . import compact as cpk
from .state import BIG, CloudState, StageCtx, live_threshold


def spreader_perf(spec, params, st: CloudState) -> torch.Tensor:
    """perf[B, S] from machine states (Eq. 5: power state gates
    processing), from each lane's own parameters."""
    B, P = st.pstate.shape
    cpu_cap = params.cpu_cap[:, None]
    cpu_on = st.pstate == PM_RUNNING
    if spec.complex_power:
        cpu_on = cpu_on | (st.pstate == PM_SWITCHING_ON) | (
            st.pstate == PM_SWITCHING_OFF)
    net_on = st.pstate != PM_OFF
    net = torch.where(net_on, params.net_bw[:, None], 0.0)
    vm_on = mc.vm_cpu_active(st.vstage) | (st.vstage == mc.VM_INITIAL_TRANSFER)
    return torch.cat([
        torch.where(cpu_on, cpu_cap, 0.0),                       # cpu
        net, net,                                                # net in/out
        params.repo_bw[:, None].expand(B, 2),                    # repo
        torch.where(vm_on, torch.clamp_min(st.vm_cores, 1.0)
                    * params.perf_core[:, None], 0.0),           # vm cpu
        cpu_cap.expand(B, P),                                    # hidden
    ], dim=1)


def advance(ctx: StageCtx, st: CloudState):
    spec, params, trace = ctx.spec, ctx.params, ctx.trace
    lay = spec.layout
    T = trace.n
    F = spec.n_vm + spec.n_pm
    t = st.t[:, None]
    thresh = live_threshold(st.f_total)
    live = st.f_active & (t >= st.f_release) & (st.f_pr > thresh)
    rate_fn = SCHEDULERS[spec.scheduler]
    perf = spreader_perf(spec, params, st)

    if cpk.compact_bucket(spec, st.t.device):
        # The solve sees the same live flows, rate limits and capacities in
        # the same index order as the dense call, so its rates are
        # bit-identical.  Fill lanes are never live; their ids are clamped
        # into the bucket so that no gather of them leaves it.
        cp = cpk.build_compact(spec, st)
        SB = cp.sidx.shape[-1]
        touched = torch.clamp_max(cp.sidx, lay.S - 1).long()
        live_b = cpk.gather_flows(cp, live, False)
        f_pr_b = cpk.gather_flows(cp, st.f_pr, 0.0)
        f_pl_b = cpk.gather_flows(cp, st.f_pl, 0.0)
        f_rel_b = cpk.gather_flows(cp, st.f_release, float("inf"))
        r_b = rate_fn(torch.clamp_max(cp.bprov, SB - 1),
                      torch.clamp_max(cp.bcons, SB - 1), f_pl_b, live_b,
                      perf.gather(1, touched), max_iters=spec.max_fill_iters)
        r = cpk.scatter_flows(cp, F, r_b)
        flow_cand = [f_pr_b / torch.clamp_min(r_b, 1e-30),  # completion [FB]
                     f_rel_b - t]                          # latency    [FB]
        flow_mask = [live_b & (r_b > 0), cp.fvalid & (t < f_rel_b)]
    else:
        cp = None
        r = rate_fn(st.f_prov, st.f_cons, st.f_pl, live, perf,
                    max_iters=spec.max_fill_iters)
        flow_cand = [st.f_pr / torch.clamp_min(r, 1e-30),  # completion   [F]
                     st.f_release - t]                     # latency      [F]
        flow_mask = [live & (r > 0), st.f_active & (t < st.f_release)]

    # ---- event horizon: one masked-min reduction ------------------------
    # Families: flow completion, latency-gate release, PM power transition,
    # and the scalar tail (allocation expiry pre-reduced, meter tick,
    # t_stop, next arrival from the presorted arrival vector).
    trans = (st.pstate == PM_SWITCHING_ON) | (st.pstate == PM_SWITCHING_OFF)
    exp_min = torch.amin(torch.where(
        (st.vstage == mc.VM_ALLOCATED) & torch.isfinite(st.vm_expiry),
        st.vm_expiry - t, BIG), dim=-1)
    true = torch.ones(st.t.shape, dtype=torch.bool, device=st.t.device)
    tail_cand = [exp_min, st.meter_next - st.t, ctx.t_stop - st.t]
    tail_mask = [true, torch.isfinite(st.meter_next),
                 torch.isfinite(ctx.t_stop)]
    # The clock is monotone and dispatch requires arrival <= t, so every
    # strictly-future arrival belongs to a PENDING task and the family's
    # minimum is the first sorted arrival past t.
    nxt = torch.searchsorted(ctx.arrival_sorted, t, right=True)
    tail_cand.append(ctx.arrival_sorted.gather(
        1, torch.clamp_max(nxt, T - 1))[:, 0] - st.t)
    tail_mask.append(nxt[:, 0] < T)
    # Streaming windows add the first arrival of the next, not yet loaded
    # window: arrivals are window-sorted, so this one sentinel is the min
    # the monolithic engine takes over every future task's arrival.  A
    # monolithic run (t_next None) keeps the candidate vector as it is.
    if ctx.t_next is not None:
        tail_cand.append(ctx.t_next - st.t)
        tail_mask.append(ctx.t_next > st.t)
    cand = torch.cat(flow_cand + [st.pstate_end - t,
                                  torch.stack(tail_cand, dim=1)], dim=1)
    mask = torch.cat(flow_mask + [trans & torch.isfinite(st.pstate_end),
                                  torch.stack(tail_mask, dim=1)], dim=1)
    dt = masked_min(cand, mask)          # one launch, one row a lane
    has_event = dt < BIG
    dt = torch.where(has_event, torch.clamp_min(dt, 0.0), 0.0)

    # ---- clock + sampled-meter tick ------------------------------------
    t_new, t_c = kahan_add(st.t, st.t_c, dt)
    tick = torch.isfinite(st.meter_next) & (st.meter_next <= t_new)
    period = params.metering_period
    meter_next = torch.where(tick, st.meter_next + period, st.meter_next)

    # ---- drain flows ----------------------------------------------------
    dtc = dt[:, None]
    f_pr = torch.where(live, torch.clamp_min(st.f_pr - r * dtc, 0.0), st.f_pr)
    done = live & (f_pr <= thresh)
    # one 2-column provider-side reduction: delivered rate (observe's
    # utilisation numerator) and processed work.  The compacted one adds
    # the same live terms in the same flow order per touched spreader and
    # scatters the sums back (an untouched spreader gains nothing).
    if cp is None:
        prov_stats = segment_sum(
            torch.stack([torch.where(live, r, 0.0),
                         torch.where(live, r * dtc, 0.0)], dim=-1),
            st.f_prov, lay.S, where=live)
        delivered = prov_stats[..., 0]
        processed = st.processed + prov_stats[..., 1]
    else:
        stats_b = segment_sum(
            torch.stack([torch.where(live_b, r_b, 0.0),
                         torch.where(live_b, r_b * dtc, 0.0)], dim=-1),
            cp.bprov, SB, where=live_b)
        delivered = scatter_drop(torch.zeros_like(st.processed), cp.sidx,
                                 stats_b[..., 0])
        processed = scatter_drop(st.processed, cp.sidx,
                                 st.processed.gather(1, touched)
                                 + stats_b[..., 1])

    ctx = ctx._replace(r=r, live=live, thresh=thresh, done=done,
                       delivered=delivered, dt=dt, t0=st.t, t_new=t_new,
                       has_event=has_event, tick=tick, period=period,
                       compact=cp)
    st = st._replace(t=t_new, t_c=t_c, n_events=st.n_events + 1,
                     meter_next=meter_next, f_pr=f_pr, processed=processed)
    return ctx, st
