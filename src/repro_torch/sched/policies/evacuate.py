"""The multi-VM evacuation PM policy (``pm_sched="evacuate"``), port of
``repro.sched.policies.evacuate``.

Consolidation moves one VM a pass; evacuation re-places a donor's running
VMs (smallest first) in one pass, up to ``CloudSpec.max_migrations``
moves, each onto the best-fit running host that still has the cores free
after the moves planned before it.  :func:`migrate_many` re-checks the
same capacity while it applies the plan, so a K-deep plan never
overcommits a destination.  The trigger and destination rules are
consolidation's, so a single-VM donor behaves exactly as under
``consolidate``.

The reference plans with a ``lax.scan``; here the plan is K device steps
(K a host number), and the victims come from a stable argsort as
``jnp.argsort`` gives them.
"""
from __future__ import annotations

import torch

from ...core.loop.migrate import migrate_many
from ...core.loop.state import CloudState
from .. import registry
from .baseline import wake_sleep_pass
from .consolidate import MIGRATION_DELTA
from .select import (INF, feasible_destinations, host_load_facts,
                     idle_dominated_donor)


def evacuation_step(spec, params, st: CloudState) -> CloudState:
    """Drain one idle-dominated donor: up to ``spec.max_migrations`` masked
    moves planned against cumulative destination capacity."""
    K = max(1, min(int(spec.max_migrations), spec.n_vm))

    running, used, movable, n_movable = host_load_facts(spec, params, st)
    donor, src = idle_dominated_donor(params, st, running, used, n_movable)

    # victims: the donor's K smallest running VMs (cheapest to re-place)
    on_src = movable & (st.vm_host == src)
    order = torch.argsort(torch.where(on_src, st.vm_cores, INF), dim=-1,
                          stable=True)
    vs = order[:, :K]
    valid = on_src.gather(1, vs)

    # plan destinations in turn: each move sees the free cores left by the
    # moves before it (best fit and load ordering as in consolidation,
    # against the loads at the start of the pass)
    pm = torch.arange(spec.n_pm, device=src.device)
    free = st.free_cores
    dsts, fits = [], []
    for k in range(K):
        need = st.vm_cores.gather(1, vs[:, k:k + 1])
        fit = feasible_destinations(running, used, free, src, need)
        dst = torch.argmin(torch.where(fit, free, INF), dim=-1, keepdim=True)
        ok = fit.any(-1, keepdim=True)
        free = torch.where(pm == dst, free + torch.where(ok, -need, 0.0),
                           free)
        dsts.append(dst)
        fits.append(ok)
    ok = valid & torch.cat(fits, dim=1) & donor.any(-1, keepdim=True)
    return migrate_many(spec, params, st, vs, torch.cat(dsts, dim=1), ok)


def evacuate(spec, params, ctx, st: CloudState) -> CloudState:
    st = wake_sleep_pass(spec, params, ctx.trace, st)
    return evacuation_step(spec, params, st)


registry.register(
    "pm", "evacuate", evacuate, code=4, requires=MIGRATION_DELTA,
    doc="consolidation trigger, but the donor drains in one pass "
        "(up to CloudSpec.max_migrations moves per iteration)")
