"""The meter-driven consolidation PM policy (``pm_sched="consolidate"``),
port of ``repro.sched.policies.consolidate``.

A PM state scheduler that reads the live per-PM direct and idle meters
and reacts inside the event loop: on-demand's wake/sleep pass, plus at
most one masked migration a pass:

* **source** — the least-loaded RUNNING host whose live meter reading is
  idle-dominated and that hosts a migratable (RUNNING) VM;
* **victim** — the smallest-cores running VM on the source;
* **destination** — the best fit: least free cores among the running
  hosts that fit the victim, are not the source, and are at least as
  loaded as the source (moves only pack; no ping-pong).

Once a donor's last VM has resumed elsewhere, the inherited sleep rule
powers it down.
"""
from __future__ import annotations

import torch

from ...core.loop.migrate import migrate_one
from ...core.loop.state import CloudState
from .. import registry
from .baseline import WAKE_SLEEP_DELTA, wake_sleep_pass
from .select import (INF, feasible_destinations, host_load_facts,
                     idle_dominated_donor, smallest_victim_on)

# wake/sleep inherited, plus one masked migration's rewrite of the victim
# slot, both hosts' cores, and the loop-liveness flag
MIGRATION_DELTA = WAKE_SLEEP_DELTA + (
    "vstage", "vm_mig_dst", "vm_saved_pr", "free_cores", "running")


def consolidation_step(spec, params, st: CloudState) -> CloudState:
    """One masked consolidation decision, driven by the live meters."""
    running, used, movable, n_movable = host_load_facts(spec, params, st)
    donor, src = idle_dominated_donor(params, st, running, used, n_movable)
    on_src, v = smallest_victim_on(st, movable, src)
    need = st.vm_cores.gather(1, v)

    fit = feasible_destinations(running, used, st.free_cores, src, need)
    dst = torch.argmin(torch.where(fit, st.free_cores, INF), dim=-1,
                       keepdim=True)

    do = donor.any(-1) & on_src.any(-1) & fit.any(-1)
    return migrate_one(spec, params, st, v, dst, do)


def consolidate(spec, params, ctx, st: CloudState) -> CloudState:
    st = wake_sleep_pass(spec, params, ctx.trace, st)
    return consolidation_step(spec, params, st)


registry.register(
    "pm", "consolidate", consolidate, code=2, requires=MIGRATION_DELTA,
    doc="on-demand + one idle-meter-driven live migration per iteration")
