"""The driver composing the staged pipeline (port of
``repro.core.loop.driver``).

One pass is exactly the stage sequence :data:`STAGES`:

    advance -> observe -> vm_lifecycle -> pm_power -> pm_sched -> vm_sched

followed by the :func:`termination` verdict.  The reference runs passes in a
``lax.while_loop``; here :func:`repro_torch.core.engine.simulate` calls the
body returned by :func:`make_body` from the host, and reads
``running & (n_events < max_events)`` once per body, i.e. once per K passes.
"""
from __future__ import annotations

import torch

from ..energy import PM_SWITCHING_OFF, PM_SWITCHING_ON
from . import advance, lifecycle, observe, pm_sched, power, vm_sched
from .state import TASK_PENDING, CloudState, StageCtx, live_threshold

STAGES = (
    advance.advance,         # §3.1/§3.2 sharing + clock-to-horizon + drain
    observe.observe_stage,   # §3.3 meter stack over [t0, t_new]
    lifecycle.vm_lifecycle,  # §3.4.3 Fig. 6 VM transitions
    power.pm_power,          # §3.4.2 PM power-state transitions
    pm_sched.pm_sched,       # §3.5.1 PM policy hook
    vm_sched.vm_sched,       # §3.5.1 VM policy hook
)

# Passes per body between two host reads of the loop condition when
# ``spec.steps_per_iter == 0``.  Every pass after the first is guarded by
# one select per state leaf (about fifty launches; a settled pass must
# leave the state untouched), while the data-dependent loops inside a pass
# read the host anyway, so the default reads the condition after every
# pass.
DEFAULT_STEPS_PER_ITER = 1


def steps_per_iter(spec) -> int:
    k = getattr(spec, "steps_per_iter", 0)
    return int(k) if k > 0 else DEFAULT_STEPS_PER_ITER


def termination(ctx: StageCtx, st: CloudState, snap) -> CloudState:
    """Continue while events remain, unless ``t_stop`` was reached; a pass
    that found no event and changed no machine/task state ends the run."""
    ts0, vs0, ps0, fa0 = snap
    trace = ctx.trace
    queued = (st.task_state == TASK_PENDING) & (trace.arrival <= st.t)
    live2 = st.f_active & (st.f_pr > live_threshold(st.f_total))
    pend2 = (st.task_state == TASK_PENDING) & (trace.arrival > st.t)
    trans2 = (st.pstate == PM_SWITCHING_ON) | (st.pstate == PM_SWITCHING_OFF)
    more = live2.any() | pend2.any() | trans2.any() | queued.any()
    hit_stop = torch.isfinite(ctx.t_stop) & (st.t >= ctx.t_stop)
    changed = ((st.task_state != ts0).any() | (st.vstage != vs0).any()
               | (st.pstate != ps0).any() | (st.f_active != fa0).any())
    return st._replace(running=(ctx.has_event | changed) & more & ~hit_stop)


def _select(cond: torch.Tensor, new, old):
    """Leaf-wise ``where(cond, new, old)`` over a state tree."""
    if torch.is_tensor(new):
        return torch.where(cond, new, old)
    return type(new)(*(_select(cond, a, b) for a, b in zip(new, old)))


def make_body(spec, params, trace, t_stop):
    """The loop body: K pipeline passes.  The first needs no guard (the
    host's loop condition admitted it); each later pass is discarded
    leaf-wise when its entry state had settled, so K passes give exactly
    the state and event count of K single passes."""
    arrival_sorted = torch.sort(trace.arrival).values

    def one_pass(st: CloudState) -> CloudState:
        ctx = StageCtx(spec=spec, params=params, trace=trace, t_stop=t_stop,
                       arrival_sorted=arrival_sorted)
        snap = (st.task_state, st.vstage, st.pstate, st.f_active)
        for stage in STAGES:
            ctx, st = stage(ctx, st)
        return termination(ctx, st, snap)

    K = steps_per_iter(spec)

    def body(st: CloudState) -> CloudState:
        st = one_pass(st)
        for _ in range(K - 1):
            cont = st.running & (st.n_events < spec.max_events)
            st = _select(cont, one_pass(st), st)
        return st

    return body


def management_pass(spec, params, trace, st: CloudState) -> CloudState:
    """The pre-loop scheduler pass: arrivals at exactly the current clock
    are served before the first horizon jump."""
    ctx = StageCtx(spec=spec, params=params, trace=trace,
                   t_stop=torch.tensor(float("inf"), device=st.t.device))
    _, st = pm_sched.pm_sched(ctx, st)
    _, st = vm_sched.vm_sched(ctx, st)
    return st
