"""The event loop's state protocol: entity constants, the dense
:class:`CloudState`, and the per-pass :class:`StageCtx` (port of
``repro.core.loop.state``).

Every stage is ``stage(ctx, st) -> (ctx, st)``.  Stages never write into a
state tensor in place: each returns new tensors for the fields it changes,
so a caller may keep the previous state as a snapshot.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..energy import MeterState

BIG = 3.0e38   # f32 "no event" sentinel (rounds to the f32 3e38 of the JAX package)


def live_threshold(f_total: torch.Tensor) -> torch.Tensor:
    """Completion epsilon: a flow is drained once its remaining work falls to
    ``1e-6 * registered_total + 1e-9``.  Shared by ``advance``'s live mask and
    the driver's termination verdict."""
    return 1e-6 * f_total + 1e-9


KIND_MIGRATE = 5

# Task states
TASK_PENDING = 0
TASK_ACTIVE = 1
TASK_DONE = 2
TASK_REJECTED = 3


class CloudState(NamedTuple):
    t: torch.Tensor          # f32 simulated clock
    t_c: torch.Tensor        # f32 Kahan compensation for the clock
    n_events: torch.Tensor   # i32

    # consumption slots: [0:V] VM flows, [V:V+P] hidden consumers
    f_pr: torch.Tensor       # f32[V+P] remaining processing
    f_total: torch.Tensor    # f32[V+P] amount at registration
    f_pl: torch.Tensor       # f32[V+P] rate limit
    f_prov: torch.Tensor     # i32[V+P]
    f_cons: torch.Tensor     # i32[V+P]
    f_active: torch.Tensor   # bool[V+P]
    f_release: torch.Tensor  # f32[V+P] latency gate
    f_kind: torch.Tensor     # i8[V+P]

    task_state: torch.Tensor  # i8[T]
    task_vm: torch.Tensor     # i32[T]
    t_done: torch.Tensor      # f32[T]

    vstage: torch.Tensor      # i8[V]
    vm_task: torch.Tensor     # i32[V]
    vm_host: torch.Tensor     # i32[V]
    vm_cores: torch.Tensor    # f32[V]
    vm_expiry: torch.Tensor   # f32[V]
    vm_saved_pr: torch.Tensor  # f32[V]
    vm_mig_dst: torch.Tensor  # i32[V]

    pstate: torch.Tensor      # i8[P]
    pstate_end: torch.Tensor  # f32[P]
    free_cores: torch.Tensor  # f32[P]

    meters: MeterState
    meter_next: torch.Tensor  # f32 next sample tick (inf when disabled)
    processed: torch.Tensor   # f32[S] provider-side utilisation counters

    overflow: torch.Tensor    # bool — VM slot pool exhausted at some dispatch
    running: torch.Tensor     # bool

    @property
    def energy_hi(self) -> torch.Tensor:
        return self.meters.pm.energy_hi

    @property
    def energy_lo(self) -> torch.Tensor:
        return self.meters.pm.energy_lo

    @property
    def energy_sampled(self) -> torch.Tensor:
        return self.meters.pm_sampled


class StageCtx(NamedTuple):
    """Read-mostly context threaded through one pipeline pass."""

    spec: Any
    params: Any
    trace: Any
    t_stop: torch.Tensor               # f32 scalar
    arrival_sorted: torch.Tensor | None = None

    # -- filled by the `advance` stage -----------------------------------
    r: torch.Tensor | None = None
    live: torch.Tensor | None = None
    thresh: torch.Tensor | None = None
    done: torch.Tensor | None = None
    delivered: torch.Tensor | None = None
    dt: torch.Tensor | None = None
    t0: torch.Tensor | None = None
    t_new: torch.Tensor | None = None
    has_event: torch.Tensor | None = None
    tick: torch.Tensor | None = None
    period: torch.Tensor | None = None

    # -- filled by the `observe` stage -----------------------------------
    view: Any = None
