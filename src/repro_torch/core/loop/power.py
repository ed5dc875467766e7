"""Stage 4 — ``pm_power``: physical-machine power-state transitions (port
of ``repro.core.loop.power``).

A transition ends when its hidden-consumer flow drains (complex model) or
at its ``pstate_end`` deadline (simple model).  The reference's event gate
is dropped: with nothing fired every write selects the old value, so
running the body is bitwise identity.

State delta: ``pstate``, ``pstate_end``, the hidden-consumer suffix of
``f_active``.
"""
from __future__ import annotations

import math

import torch

from ..energy import PM_OFF, PM_RUNNING, PM_SWITCHING_OFF, PM_SWITCHING_ON
from .state import CloudState, StageCtx


def pm_power(ctx: StageCtx, st: CloudState):
    spec = ctx.spec
    V = spec.n_vm

    hdone = ctx.done[V:]
    pstate = st.pstate
    pstate_end = st.pstate_end
    if spec.complex_power:
        pstate = torch.where(hdone & (pstate == PM_SWITCHING_ON),
                             PM_RUNNING, pstate)
        pstate = torch.where(hdone & (pstate == PM_SWITCHING_OFF),
                             PM_OFF, pstate)
    f_active = torch.cat([st.f_active[:V],
                          torch.where(hdone, False, st.f_active[V:])])

    ponend = (pstate == PM_SWITCHING_ON) & (pstate_end <= ctx.t_new)
    poffend = (pstate == PM_SWITCHING_OFF) & (pstate_end <= ctx.t_new)
    pstate = torch.where(ponend, PM_RUNNING, pstate)
    pstate = torch.where(poffend, PM_OFF, pstate)
    pstate_end = torch.where(ponend | poffend, math.inf, pstate_end)

    return ctx, st._replace(pstate=pstate, pstate_end=pstate_end,
                            f_active=f_active)
