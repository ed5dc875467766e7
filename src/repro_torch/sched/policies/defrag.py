"""The defragmentation PM policy (``pm_sched="defrag"``), port of
``repro.sched.policies.defrag``.

Migrates toward bin-packing targets whenever packing is possible at all:
when the least-loaded host's smallest running VM fits on a more-loaded
running host, move it there, and let the inherited on-demand sleep rule
power the emptied donor down.  No idle threshold is involved.

Guards (all masked, so a refused pass is a bitwise no-op): only with an
empty request queue; the destination at least as loaded as the donor (no
ping-pong); at most one move a pass.
"""
from __future__ import annotations

import torch

from ...core.loop.migrate import migrate_one
from ...core.loop.state import TASK_PENDING, CloudState
from .. import registry
from .baseline import wake_sleep_pass
from .consolidate import MIGRATION_DELTA
from .select import (INF, feasible_destinations, host_load_facts,
                     smallest_victim_on)


def defrag_step(spec, params, trace, st: CloudState) -> CloudState:
    """One masked bin-packing move: the least-loaded donor's smallest VM
    onto the most-loaded running host that fits it."""
    running, used, movable, n_movable = host_load_facts(spec, params, st)
    queued = ((st.task_state == TASK_PENDING)
              & (trace.arrival <= st.t[:, None]))

    donor = running & (n_movable > 0)
    src = torch.argmin(torch.where(donor, used, INF), dim=-1, keepdim=True)

    on_src, v = smallest_victim_on(st, movable, src)
    need = st.vm_cores.gather(1, v)

    # bin-packing target: the most-loaded running host the victim fits
    fit = feasible_destinations(running, used, st.free_cores, src, need)
    dst = torch.argmax(torch.where(fit, used, -INF), dim=-1, keepdim=True)

    do = ~queued.any(-1) & donor.any(-1) & on_src.any(-1) & fit.any(-1)
    return migrate_one(spec, params, st, v, dst, do)


def defrag(spec, params, ctx, st: CloudState) -> CloudState:
    st = wake_sleep_pass(spec, params, ctx.trace, st)
    return defrag_step(spec, params, ctx.trace, st)


registry.register(
    "pm", "defrag", defrag, code=3, requires=MIGRATION_DELTA,
    doc="on-demand + bin-packing migrations toward the most-loaded "
        "feasible host (no idle-threshold trigger)")
