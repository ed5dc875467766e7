"""The driver composing the staged pipeline (port of
``repro.core.loop.driver``).

One pass is exactly the stage sequence :data:`STAGES`:

    advance -> observe -> vm_lifecycle -> pm_power -> pm_sched -> vm_sched

followed by the :func:`termination` verdict, over every lane of the batch
at once (B = 1 for a single scenario).  The reference runs passes in a
(vmapped) ``lax.while_loop``; here :func:`repro_torch.core.engine.simulate`
and ``simulate_batch`` call the body returned by :func:`make_body` from the
host, and read the lanes' loop condition ``running & (n_events <
max_events)`` once per body, i.e. once per K passes, as one small code.
A lane whose condition is false keeps its state, leaf by leaf, as the
vmapped ``while_loop`` keeps a finished lane; the body runs that guard
only when some lane has settled.  With active-set compaction on, each
pass also yields each lane's bucket verdict ``ok``; the body folds it on
the device and the engine reads it in the same read.
"""
from __future__ import annotations

import math

import torch

from ..energy import PM_SWITCHING_OFF, PM_SWITCHING_ON
from . import advance, lifecycle, observe, pm_sched, power, vm_sched
from .state import (TASK_PENDING, CloudState, StageCtx, live_threshold,
                    select_lanes)

STAGES = (
    advance.advance,         # §3.1/§3.2 sharing + clock-to-horizon + drain
    observe.observe_stage,   # §3.3 meter stack over [t0, t_new]
    lifecycle.vm_lifecycle,  # §3.4.3 Fig. 6 VM transitions
    power.pm_power,          # §3.4.2 PM power-state transitions
    pm_sched.pm_sched,       # §3.5.1 PM policy hook
    vm_sched.vm_sched,       # §3.5.1 VM policy hook
)

# The management suffix of the pipeline (the policy hooks).  Streaming
# windows discard exactly these two stages on the hand-over pass (the one
# whose horizon lands the clock on the next window's first arrival): the
# monolithic engine runs them with that arrival already queued, so the
# next window's step runs them again once the arrival is loaded.
N_MANAGEMENT_STAGES = 2

# Passes per body between two host reads of the loop condition when
# ``spec.steps_per_iter == 0``.  Every pass after the first is guarded by
# one select per state leaf (about fifty launches; a settled lane must
# keep its state), while the data-dependent loops inside a pass read the
# host anyway, so the default reads the condition after every pass.
DEFAULT_STEPS_PER_ITER = 1


def steps_per_iter(spec) -> int:
    k = getattr(spec, "steps_per_iter", 0)
    return int(k) if k > 0 else DEFAULT_STEPS_PER_ITER


def termination(ctx: StageCtx, st: CloudState, snap) -> CloudState:
    """Continue while events remain, unless ``t_stop`` was reached; a pass
    that found no event and changed no machine/task state ends the run (of
    each lane)."""
    ts0, vs0, ps0, fa0 = snap
    trace = ctx.trace
    t = st.t[:, None]
    queued = (st.task_state == TASK_PENDING) & (trace.arrival <= t)
    live2 = st.f_active & (st.f_pr > live_threshold(st.f_total))
    pend2 = (st.task_state == TASK_PENDING) & (trace.arrival > t)
    trans2 = (st.pstate == PM_SWITCHING_ON) | (st.pstate == PM_SWITCHING_OFF)
    more = (live2.any(-1) | pend2.any(-1) | trans2.any(-1)
            | queued.any(-1))
    hit_stop = torch.isfinite(ctx.t_stop) & (st.t >= ctx.t_stop)
    if ctx.t_next is not None:
        # streaming: the tasks of later windows are work that remains, and
        # reaching the next window's first arrival ends this window's loop
        # (the next step resumes from the same carried state)
        more = more | (ctx.t_next > st.t)
        hit_stop = hit_stop | (st.t >= ctx.t_next)
    changed = ((st.task_state != ts0).any(-1) | (st.vstage != vs0).any(-1)
               | (st.pstate != ps0).any(-1) | (st.f_active != fa0).any(-1))
    return st._replace(running=(ctx.has_event | changed) & more & ~hit_stop)


def lanes_going(spec, st: CloudState) -> torch.Tensor:
    """bool[B]: the lanes whose loop goes on."""
    return st.running & (st.n_events < spec.max_events)


def make_body(spec, params, trace, t_stop, t_next=None):
    """The loop body ``body(st, guard) -> (st, ok)``: K pipeline passes.
    ``guard`` is None when every lane goes on (the host's read said so),
    else the lanes' loop condition [B]: the lanes it excludes keep their
    state through the first pass.  Each later pass is discarded leaf-wise
    in the lanes whose entry state had settled, so K passes give exactly
    the state and event count of K single passes.  ``ok`` [B] is the
    compaction verdict of the passes kept (a device bool a lane), None
    when compaction is off.

    ``t_next`` (streaming windows only) is the first arrival of the next
    trace window, a host float shared by every lane.  ``None``, or
    ``inf`` for the last window (where the sentinel's candidate, its
    termination terms and the hand-over select can change nothing),
    composes exactly the monolithic body."""
    arrival_sorted = torch.sort(trace.arrival, dim=-1).values
    if t_next is not None and math.isfinite(t_next):
        t_next = torch.full(t_stop.shape, t_next, dtype=torch.float32,
                            device=t_stop.device)
    else:
        t_next = None

    def one_pass(st: CloudState):
        ctx = StageCtx(spec=spec, params=params, trace=trace, t_stop=t_stop,
                       t_next=t_next, arrival_sorted=arrival_sorted)
        snap = (st.task_state, st.vstage, st.pstate, st.f_active)
        for stage in STAGES[:-N_MANAGEMENT_STAGES]:
            ctx, st = stage(ctx, st)
        st_pre = st
        for stage in STAGES[-N_MANAGEMENT_STAGES:]:
            ctx, st = stage(ctx, st)
        if t_next is not None:
            # the hand-over pass: the clock reached the next window's first
            # arrival, so the management stages ran without that (not yet
            # loaded) task queued.  Discard their delta in those lanes; the
            # next window's step replays them with the arrival present.
            st = select_lanes(st_pre.t >= t_next, st_pre, st)
        ok = None if ctx.compact is None else ctx.compact.ok
        return termination(ctx, st, snap), ok

    def guarded(cont, st, ok):
        """One pass kept in the lanes of ``cont``; a discarded pass's
        bucket does not count."""
        new, ok_k = one_pass(st)
        st = select_lanes(cont, new, st)
        if ok_k is not None:
            ok_k = ok_k | ~cont
            ok = ok_k if ok is None else ok & ok_k
        return st, ok

    K = steps_per_iter(spec)

    def body(st: CloudState, guard=None):
        if guard is None:
            st, ok = one_pass(st)
        else:
            st, ok = guarded(guard, st, None)
        for _ in range(K - 1):
            st, ok = guarded(lanes_going(spec, st), st, ok)
        return st, ok

    return body


def management_pass(spec, params, trace, st: CloudState) -> CloudState:
    """The pre-loop scheduler pass: arrivals at exactly the current clock
    are served before the first horizon jump."""
    t = st.t
    ctx = StageCtx(spec=spec, params=params, trace=trace,
                   t_stop=torch.full(t.shape, float("inf"), device=t.device))
    _, st = pm_sched.pm_sched(ctx, st)
    _, st = vm_sched.vm_sched(ctx, st)
    return st
