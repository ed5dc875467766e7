"""The event loop's state protocol: entity constants, the dense
:class:`CloudState`, and the per-pass :class:`StageCtx` (port of
``repro.core.loop.state``).

Every stage is ``stage(ctx, st) -> (ctx, st)``.  Stages never write into a
state tensor in place: each returns new tensors for the fields it changes,
so a caller may keep the previous state as a snapshot.

**The lane axis.**  Inside the loop every state and context tensor has a
leading lane axis, one lane a scenario of a batch: the clock and the other
scalars are [B], an entity vector is [B, N].  A single scenario is the
batch of one lane (B = 1), squeezed at the engine's boundary
(:func:`add_lane` / :func:`drop_lane`), so one copy of the stages serves
both.  The stages compute each lane as that lane alone would be computed:
elementwise ops, gathers and the reductions along the last axis are
lane-local, segment sums offset each lane's ids apart, and the float sums
whose rounding could depend on the lane count reduce each lane by itself
(:func:`repro_torch.core.arrays.lane_sum`).
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
    """The loop's state; shapes as in one scenario, each with a leading
    [B] inside the loop."""

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
    params: Any                        # LaneParams: every leaf [B, ...]
    trace: Any                         # Trace of [B, T] tensors
    t_stop: torch.Tensor               # f32[B]
    # Streaming windows: the first arrival of the next trace window, one
    # value a lane (the windows are shared, so every lane holds the same),
    # always finite; None in a monolithic run and in a stream's last
    # window.  It joins the horizon candidates, keeps termination's "work
    # remains" true while windows remain, and gates the management stages
    # off on the hand-over pass (`loop.driver.make_body`).
    t_next: torch.Tensor | None = None           # f32[B]
    arrival_sorted: torch.Tensor | None = None   # f32[B, T]

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
    compact: Any = None        # the pass's Compact gather (None: dense)

    # -- filled by the `observe` stage -----------------------------------
    view: Any = None


def _tree_map(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    return tree


def add_lane(tree):
    """A single scenario's state (or any NamedTuple tree of tensors) as the
    batch of one lane: every tensor gains a leading axis of 1 (a view)."""
    return _tree_map(lambda t: t.unsqueeze(0), tree)


def drop_lane(tree, lane: int = 0):
    """Lane ``lane`` of a batched tree, as a single scenario's tree (a
    view)."""
    return _tree_map(lambda t: t[lane], tree)


def select_lanes(cond: torch.Tensor, new, old):
    """Leaf-wise ``where(cond, new, old)`` over two trees of one shape,
    ``cond`` [B] picking lane by lane (broadcast over each leaf's other
    axes).  A leaf that is the same tensor in both trees is kept as it
    is: the select could not change it."""
    if new is old:
        return new
    if torch.is_tensor(new):
        c = cond.reshape(cond.shape + (1,) * (new.dim() - cond.dim()))
        return torch.where(c, new, old)
    return type(new)(*(select_lanes(cond, a, b) for a, b in zip(new, old)))
