"""Stage 5 — ``pm_sched``: the PM state-scheduler policy hook (port of
``repro.core.loop.pm_sched``).

The stage calls the policy that ``params.pm_sched`` names in the registry.
The reference skips the policy when its registered trigger is False; the
trigger contract makes the policy bitwise identity then, so the port runs
it unconditionally and needs no host read for the gate.
"""
from __future__ import annotations

from ...sched import registry
from .state import CloudState, StageCtx


def pm_sched(ctx: StageCtx, st: CloudState):
    policy = registry.get("pm", ctx.params.pm_sched)
    return ctx, policy.fn(ctx.spec, ctx.params, ctx, st)
