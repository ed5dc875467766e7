"""The IaaS cloud engine (paper §3.1-§3.5 in one event loop), port of
``repro.core.engine``'s single-scenario and batched paths.

* :class:`CloudSpec` — shapes, topology and algorithm choices.  The
  reference's ``backend`` switch has no counterpart: the device of the
  tensors picks the hand-written kernels (CUDA) or their plain versions
  (CPU).
* :class:`CloudParams` — every continuous knob plus the VM/PM policy codes.
* :func:`simulate` — runs a trace to completion and returns a
  :class:`CloudResult`.  The staged pipeline (:mod:`repro_torch.core.loop`)
  runs from the host; the host reads the loop condition once per body,
  together with the compaction verdict (an overflowing bucket replays
  the scenario dense, with a ``RuntimeWarning``).
* :func:`simulate_batch` — the same for a batch of scenarios, one lane
  each, from :func:`stack_params` / :func:`stack_traces` or any
  :class:`Trace` / :class:`CloudParams` leaf with a leading batch axis
  (the others broadcast).  The loop runs every lane in the same passes,
  so each kernel launch serves all lanes; lane ``i`` equals
  ``simulate`` of lane ``i`` bit for bit.  :func:`simulate` is the batch
  of one lane, squeezed at its boundary: one copy of the stages.
* :func:`start_migration` / :func:`make_allocation` — out-of-loop state
  edits (a live migration, an expiring core reservation).

Entry points run on CUDA unless called with ``device="cpu"``.
:func:`params_from_numpy`, :func:`trace_from_numpy` and
:func:`state_from_numpy` build the port's objects from plain numpy arrays
keyed by the reference's (dotted) field names; :func:`to_numpy` flattens
the port's objects the same way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..sched import registry as _policy_registry
from . import loop
from . import machine as mc
from .energy import (PM_OFF, PM_RUNNING, MeterAccum, MeterParams, MeterState,
                     MeterTopology, PowerStateTable, meter_readings)
from .fairshare import SCHEDULERS
from .arrays import lane_sum, scatter_drop
from .loop.state import (BIG as _BIG, TASK_DONE, TASK_PENDING, TASK_REJECTED,
                         CloudState, add_lane, drop_lane, select_lanes)

__all__ = ["CloudSpec", "CloudParams", "CloudState", "CloudResult", "Trace",
           "LaneParams", "make_cloud", "stack_params", "stack_traces",
           "lane_params", "init_state", "simulate", "simulate_batch",
           "simulate_batch_sharded", "StreamCarry", "StreamResult",
           "default_n_slots", "init_stream", "simulate_stream",
           "dense_spec", "start_migration", "make_allocation",
           "params_from_numpy", "trace_from_numpy", "state_from_numpy",
           "to_numpy"]


@dataclasses.dataclass(frozen=True)
class CloudSpec:
    """Static cloud description (shapes, topology, algorithm choices)."""

    n_pm: int = 4
    n_vm: int = 64
    complex_power: bool = False
    scheduler: str = "maxmin"
    max_events: int = 2_000_000
    max_fill_iters: int = 64
    max_migrations: int = 4
    meters: MeterTopology = MeterTopology()
    compact: int = -1            # -1 auto (dense on CUDA), 0 off, > 0 a bucket
    steps_per_iter: int = 0      # passes per host check (0 = default)

    def __post_init__(self):
        if self.scheduler not in SCHEDULERS:
            raise ValueError(f"unknown sharing scheduler {self.scheduler!r}; "
                             f"registered: {sorted(SCHEDULERS)}")
        if self.compact < -1:
            raise ValueError(f"spec.compact must be -1 (auto), 0 (off) or a "
                             f"positive bucket size, got {self.compact}")
        if self.steps_per_iter < 0:
            raise ValueError(f"spec.steps_per_iter must be >= 0, got "
                             f"{self.steps_per_iter}")

    @property
    def layout(self) -> mc.SpreaderLayout:
        return mc.SpreaderLayout(self.n_pm, self.n_vm)


def _sched_code(value, layer: str):
    """A scheduler name or code as its registered integer code; a batch of
    names or codes (a list, array or tensor with a leading batch axis) as
    an int32 tensor of codes."""
    names = _policy_registry.names(layer)
    if isinstance(value, str):
        if value not in names:
            raise ValueError(f"unknown scheduler {value!r}; one of {names}")
        return names.index(value)
    arr = np.asarray(value.cpu() if torch.is_tensor(value) else value)
    if arr.ndim:
        return torch.tensor([_sched_code(v, layer) for v in arr.tolist()],
                            dtype=torch.int32)
    code = int(arr)
    if not 0 <= code < len(names):
        raise ValueError(f"scheduler code {code} out of range; "
                         f"0..{len(names) - 1} index {names}")
    return code


@dataclasses.dataclass(frozen=True)
class CloudParams:
    """Continuous cloud parameters and the policy codes.

    A scalar is a host number, or a tensor / array whose leading axis is a
    batch for :func:`simulate_batch` (then ``vm_sched`` / ``pm_sched`` hold
    an int32 tensor of codes); ``power`` and ``meter`` hold tensors whose
    rows may carry the batch axis likewise.  The engine reads them through
    :func:`lane_params`."""

    pm_cores: float = 64.0
    perf_core: float = 1.0
    net_bw: float = 125.0
    repo_bw: float = 250.0
    image_mb: float = 100.0
    boot_work: float = 10.0
    vm_mem_mb: float = 1024.0
    latency_s: float = 0.001
    metering_period: float = 0.0
    hidden_work_on: float = 40.0
    hidden_work_off: float = 2.4
    vm_sched: object = 0
    pm_sched: object = 0
    consolidate_idle_frac: float = 0.6
    power: PowerStateTable = None
    meter: MeterParams = None

    def __post_init__(self):
        object.__setattr__(self, "vm_sched", _sched_code(self.vm_sched, "vm"))
        object.__setattr__(self, "pm_sched", _sched_code(self.pm_sched, "pm"))
        if self.power is None:
            object.__setattr__(self, "power", PowerStateTable.simple())
        if self.meter is None:
            object.__setattr__(self, "meter",
                               MeterParams.for_topology(MeterTopology()))

    @classmethod
    def for_spec(cls, spec: CloudSpec, **kw) -> "CloudParams":
        if "power" not in kw:
            kw["power"] = (PowerStateTable.complex_model()
                           if spec.complex_power else PowerStateTable.simple())
        if "meter" not in kw:
            kw["meter"] = MeterParams.for_topology(spec.meters)
        return cls(**kw)


def make_cloud(**kw) -> tuple[CloudSpec, CloudParams]:
    """Build a (CloudSpec, CloudParams) pair from one flat kwargs dict."""
    spec_names = {f.name for f in dataclasses.fields(CloudSpec)}
    param_names = {f.name for f in dataclasses.fields(CloudParams)}
    unknown = set(kw) - spec_names - param_names
    if unknown:
        raise TypeError(f"unknown cloud option(s): {sorted(unknown)}")
    spec = CloudSpec(**{k: v for k, v in kw.items() if k in spec_names})
    params = CloudParams.for_spec(
        spec, **{k: v for k, v in kw.items() if k in param_names})
    return spec, params


_FLOAT_FIELDS = ("pm_cores", "perf_core", "net_bw", "repo_bw", "image_mb",
                 "boot_work", "vm_mem_mb", "latency_s", "metering_period",
                 "hidden_work_on", "hidden_work_off",
                 "consolidate_idle_frac")
_CODE_FIELDS = ("vm_sched", "pm_sched")


def _as_tensor(x, dtype=None) -> torch.Tensor:
    """``x`` (number, array or tensor) as a CPU-or-device tensor."""
    if torch.is_tensor(x):
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _leaves(params: CloudParams):
    """``(name, value, dims of one scenario, dtype)`` of every leaf."""
    for f in _FLOAT_FIELDS:
        yield f, getattr(params, f), 0, torch.float32
    for f in _CODE_FIELDS:
        yield f, getattr(params, f), 0, torch.int32
    for k in PowerStateTable._fields:
        yield f"power.{k}", getattr(params.power, k), 1, None
    for k in ("indirect_base", "indirect_coeff"):
        yield f"meter.{k}", getattr(params.meter, k), 1, torch.float32


def _grouped(leaves: dict) -> dict:
    """Keyword arguments of :class:`CloudParams` from ``{leaf name:
    tensor}`` (the names of :func:`_leaves`)."""
    kw = {f: leaves[f] for f in _FLOAT_FIELDS + _CODE_FIELDS}
    kw["power"] = PowerStateTable(*(leaves[f"power.{k}"]
                                    for k in PowerStateTable._fields))
    kw["meter"] = MeterParams(indirect_base=leaves["meter.indirect_base"],
                              indirect_coeff=leaves["meter.indirect_coeff"])
    return kw


def stack_params(params) -> CloudParams:
    """Stack parameter points leaf-wise along a new leading batch axis
    (input to :func:`simulate_batch`): every scalar becomes an f32 [B]
    tensor (the codes int32), every table row [B, ...]."""
    rows = [{name: _as_tensor(value, dtype).cpu()
             for name, value, _, dtype in _leaves(p)} for p in params]
    if not rows:
        raise ValueError("stack_params needs at least one CloudParams")
    return CloudParams(**_grouped({k: torch.stack([r[k] for r in rows])
                                   for k in rows[0]}))


class Trace(NamedTuple):
    """Task trace: one VM request per task (paper §4.2.2 protocol).  The
    generators in :mod:`repro_torch.core.trace` fill it with numpy arrays;
    :meth:`to` gives the device tensors the engine runs on.

    ``gid`` is the streaming engine's global task id: ``None`` for a
    monolithic trace (the task axis is the id), an i32[T] for a window or
    a slot table, where recycled slots hold any ids and ``-1`` marks a
    free or padded slot."""

    arrival: object  # f32[T] submission times
    cores: object    # f32[T]
    work: object     # f32[T] total processing units
    gid: object = None  # i32[T] global ids (streaming); -1 free / pad

    @property
    def n(self) -> int:
        """Tasks per scenario (the last axis; a batch leads it)."""
        return self.arrival.shape[-1]

    def to(self, device) -> "Trace":
        """Every field as a tensor on ``device`` (f32, ``gid`` int32; a
        missing ``gid`` stays ``None``)."""
        return Trace(*(None if x is None
                       else _as_tensor(x, _TRACE_DTYPES[k]).to(device)
                       for k, x in zip(Trace._fields, self)))


_TRACE_DTYPES = {"arrival": torch.float32, "cores": torch.float32,
                 "work": torch.float32, "gid": torch.int32}


def stack_traces(traces) -> Trace:
    """Stack equal-length traces along a new leading batch axis (input to
    :func:`simulate_batch`); [B, T] CPU tensors (f32, ``gid`` int32)."""
    traces = list(traces)
    if not traces:
        raise ValueError("stack_traces needs at least one trace")
    lengths = [t.n for t in traces]
    if len(set(lengths)) > 1:
        raise ValueError(
            f"stack_traces needs equal-length traces (one task axis for the "
            f"batch), got lengths {lengths}; pad the traces to one length, "
            f"or chunk them with repro_torch.core.trace.chunk_trace and "
            f"replay them through simulate_stream")
    with_gid = [t.gid is not None for t in traces]
    if any(with_gid) and not all(with_gid):
        raise ValueError(
            "stack_traces cannot mix gid-carrying (streaming) and "
            "monolithic traces: set gid on all windows or on none")
    return Trace(*(None if not with_gid[0] and k == "gid" else
                   torch.stack([_as_tensor(getattr(t, k), _TRACE_DTYPES[k])
                                .cpu() for t in traces])
                   for k in Trace._fields))


class LaneParams(NamedTuple):
    """:class:`CloudParams` as the event loop reads them, one lane a
    scenario: every scalar an f32 [B] tensor on the run's device, the
    power table's and meter coefficients' rows [B, ...], the policy codes
    both on the device (int32 [B], for the per-lane selects) and on the
    host (read once per call; the stages dispatch on them).  Built by
    :func:`lane_params`."""

    pm_cores: torch.Tensor
    perf_core: torch.Tensor
    net_bw: torch.Tensor
    repo_bw: torch.Tensor
    image_mb: torch.Tensor
    boot_work: torch.Tensor
    vm_mem_mb: torch.Tensor
    latency_s: torch.Tensor
    metering_period: torch.Tensor
    hidden_work_on: torch.Tensor
    hidden_work_off: torch.Tensor
    consolidate_idle_frac: torch.Tensor
    vm_sched: torch.Tensor
    pm_sched: torch.Tensor
    power: PowerStateTable
    meter: MeterParams
    vm_codes: tuple
    pm_codes: tuple
    cpu_cap: torch.Tensor      # pm_cores * perf_core
    util_cap: torch.Tensor     # cpu_cap, at least 1e-30 (observe's divisor)


def _ndim(x) -> int:
    return x.dim() if torch.is_tensor(x) else np.ndim(x)


def lane_params(params: CloudParams, n_lanes: int, device) -> LaneParams:
    """The lane view of ``params`` for a batch of ``n_lanes``: each leaf
    with a leading batch axis of ``n_lanes`` keeps it, each other leaf
    broadcasts to every lane."""
    B = n_lanes
    dev = torch.device(device)
    out = {}
    for name, value, dims, dtype in _leaves(params):
        t = _as_tensor(value, dtype).cpu()
        if t.dim() == dims:
            t = t.expand((B,) + tuple(t.shape))
        elif t.dim() != dims + 1 or t.shape[0] != B:
            raise ValueError(f"CloudParams.{name} has shape "
                             f"{tuple(t.shape)}; expected {dims} dim(s) of "
                             f"one scenario, or a leading batch axis of "
                             f"{B}")
        out[name] = t.contiguous()
    kw = _grouped({k: t.to(dev) for k, t in out.items()})
    kw["vm_codes"] = tuple(out["vm_sched"].tolist())
    kw["pm_codes"] = tuple(out["pm_sched"].tolist())
    kw["cpu_cap"] = kw["pm_cores"] * kw["perf_core"]
    kw["util_cap"] = torch.clamp_min(kw["cpu_cap"], 1e-30)
    return LaneParams(**kw)


def _batch_size(trace: Trace, params: CloudParams) -> int:
    """The batch size of ``simulate_batch``'s inputs: the leading axis of
    every batched leaf, which must agree."""
    sizes = {}
    for k in Trace._fields:
        x = getattr(trace, k)
        if x is not None and _ndim(x) > 1:
            sizes[f"trace.{k}"] = int(x.shape[0])
    for name, value, dims, _ in _leaves(params):
        if _ndim(value) > dims:
            sizes[f"params.{name}"] = int(_as_tensor(value).shape[0])
    if not sizes:
        raise ValueError(
            "simulate_batch needs at least one batched leaf (leading batch "
            "axis) in `trace` or `params`; use simulate() for a single "
            "scenario")
    if len(set(sizes.values())) > 1:
        raise ValueError(f"simulate_batch: the batched leaves disagree on "
                         f"the batch size: {sizes}")
    return next(iter(sizes.values()))


def _trace_lanes(trace: Trace, n_lanes: int, device) -> Trace:
    """Every field of ``trace`` as [B, T] on ``device`` (an unbatched
    field broadcast to every lane, as a view)."""
    trace = trace.to(device)
    return Trace(*(x if x is None or x.dim() == 2
                   else x.expand(n_lanes, x.shape[-1]) for x in trace))


class CloudResult(NamedTuple):
    """What a run returns; every leaf of a :func:`simulate_batch` result
    has the batch as its leading axis."""

    state: CloudState
    completion: torch.Tensor   # f32[T] task completion times (inf: unfinished)
    rejected: torch.Tensor     # bool[T]
    energy: torch.Tensor       # f32[P] per-PM energy (view of meters.pm)
    energy_sampled: torch.Tensor  # f32[P]
    meters: MeterState
    n_events: torch.Tensor
    t_end: torch.Tensor
    overflow: torch.Tensor

    def readings(self, spec: CloudSpec) -> dict[str, torch.Tensor]:
        """Named energy readings of the stack ([B, ...] for a batch)."""
        return meter_readings(spec.meters, self.meters)


def _check_meter_params(spec: CloudSpec, params: CloudParams) -> None:
    K = spec.meters.n_indirect
    for name in ("indirect_base", "indirect_coeff"):
        shape = tuple(torch.as_tensor(getattr(params.meter, name)).shape)
        if shape[-1:] != (K,):
            raise ValueError(f"CloudParams.meter.{name} has shape {shape} but "
                             f"spec.meters declares {K} indirect meter(s)")


def _init_lanes(spec: CloudSpec, T: int, params: LaneParams,
                dev) -> CloudState:
    """The initial state of every lane of ``params``."""
    B = params.pm_cores.shape[0]
    P, V = spec.n_pm, spec.n_vm
    F = V + P

    def full(n, value, dtype):
        return torch.full((B, n), value, dtype=dtype, device=dev)

    def lanes(value, dtype=torch.float32):
        return torch.full((B,), value, dtype=dtype, device=dev)

    # policies registered with starts_running=True (always-on) begin with
    # the fleet powered on, lane by lane
    start = set(_policy_registry.start_running_codes())
    pstate0 = torch.tensor([PM_RUNNING if c in start else PM_OFF
                            for c in params.pm_codes], dtype=torch.int8)
    period = params.metering_period
    return CloudState(
        t=lanes(0.0), t_c=lanes(0.0), n_events=lanes(0, torch.int32),
        f_pr=full(F, 0.0, torch.float32), f_total=full(F, 0.0, torch.float32),
        f_pl=full(F, _BIG, torch.float32), f_prov=full(F, 0, torch.int32),
        f_cons=full(F, 0, torch.int32), f_active=full(F, False, torch.bool),
        f_release=full(F, 0.0, torch.float32), f_kind=full(F, 0, torch.int8),
        task_state=full(T, TASK_PENDING, torch.int8),
        task_vm=full(T, -1, torch.int32),
        t_done=full(T, math.inf, torch.float32),
        vstage=full(V, mc.VM_FREE, torch.int8),
        vm_task=full(V, -1, torch.int32),
        vm_host=full(V, 0, torch.int32),
        vm_cores=full(V, 0.0, torch.float32),
        vm_expiry=full(V, math.inf, torch.float32),
        vm_saved_pr=full(V, 0.0, torch.float32),
        vm_mig_dst=full(V, 0, torch.int32),
        pstate=pstate0[:, None].expand(B, P).contiguous().to(dev),
        pstate_end=full(P, math.inf, torch.float32),
        free_cores=params.pm_cores[:, None].expand(B, P).contiguous(),
        meters=MeterState.zero(spec.meters, P, V, B, device=dev),
        meter_next=torch.where(period > 0, period, math.inf),
        processed=full(spec.layout.S, 0.0, torch.float32),
        overflow=lanes(False, torch.bool),
        running=lanes(True, torch.bool),
    )


def init_state(spec: CloudSpec, trace: Trace,
               params: CloudParams | None = None, *,
               device=None) -> CloudState:
    """The initial state of one scenario."""
    dev = resolve_device(device)
    if params is None:
        params = CloudParams.for_spec(spec)
    _check_meter_params(spec, params)
    return drop_lane(_init_lanes(spec, trace.n, lane_params(params, 1, dev),
                                 dev))


def dense_spec(spec: CloudSpec) -> CloudSpec:
    """``spec`` with active-set compaction off: the overflow replay's
    target (bit-identical results, no bucket to overflow)."""
    return dataclasses.replace(spec, compact=0)


def _warn_dense_rerun(spec: CloudSpec, dev):
    import warnings
    from .loop.compact import compact_bucket
    warnings.warn(
        f"active-set compaction bucket ({compact_bucket(spec, dev)}) "
        f"overflowed; replaying the scenario with compact=0 (results are bit-identical; "
        f"set spec.compact to a larger bucket to avoid the replay)",
        RuntimeWarning, stacklevel=3)


def _host_loop(spec, body, st: CloudState):
    """Run ``body`` from the host until no lane goes on; returns ``(st,
    ok)``, ``ok`` the compaction verdict of its passes (None when
    compaction is off or no pass ran, else a host bool).  The passes fold
    the verdict on the device; the host reads it in the same read as the
    lanes' loop condition, once per body, and stops at the first body
    whose bucket overflowed in any lane."""
    B = st.t.shape[0]
    ok = None        # the device verdict of the passes so far, a lane each
    while True:
        go = loop.lanes_going(spec, st)
        # one read: B every lane goes on, 1..B-1 some do (the body then
        # keeps the settled lanes), 0 none, -1 a bucket overflowed
        code = go.sum()
        if ok is not None:
            code = torch.where(ok.all(), code, -1)
        n_go = int(code)
        if n_go <= 0:
            if ok is not None:
                ok = n_go == 0
            return st, ok
        st, ok_body = body(st, None if n_go == B else go)
        if ok_body is not None:
            ok = ok_body if ok is None else ok & ok_body


def _simulate_impl(spec, trace, params, state, t_stop, dev):
    """The staged pipeline run from the host over every lane of ``params``
    (a :class:`LaneParams`; ``trace`` [B, T] on ``dev``); returns
    ``(result, ok)``, ``ok`` the compaction verdict of :func:`_host_loop`
    (a bucket that overflowed in any lane stops the loop, since the batch
    is replayed dense anyway)."""
    B = params.pm_cores.shape[0]
    st = _init_lanes(spec, trace.n, params, dev) if state is None else state
    st = loop.management_pass(spec, params, trace, st)
    t_stop = torch.full((B,), t_stop, dtype=torch.float32, device=dev)
    st, ok = _host_loop(spec, loop.make_body(spec, params, trace, t_stop), st)
    return CloudResult(
        state=st,
        completion=st.t_done,
        rejected=st.task_state == TASK_REJECTED,
        energy=st.meters.pm.energy,
        energy_sampled=st.meters.pm_sampled,
        meters=st.meters,
        n_events=st.n_events,
        t_end=st.t,
        overflow=st.overflow,
    ), ok


def _run_lanes(spec, trace, params, state, t_stop, dev) -> CloudResult:
    """:func:`_simulate_impl`, replayed dense (under a ``RuntimeWarning``)
    when a lane's compaction bucket overflowed."""
    res, ok = _simulate_impl(spec, trace, params, state, t_stop, dev)
    if ok is False:       # a bucket overflowed: replay the whole batch dense
        _warn_dense_rerun(spec, dev)
        res, _ = _simulate_impl(dense_spec(spec), trace, params, None,
                                t_stop, dev)
    return res


def simulate(spec: CloudSpec, trace: Trace,
             params: CloudParams | None = None,
             state: CloudState | None = None,
             t_stop: float = math.inf, *, device=None) -> CloudResult:
    """Run the cloud to completion (or ``t_stop``).

    ``device=None`` runs on CUDA and raises when no card is present;
    ``device="cpu"`` runs the plain PyTorch path.  A caller's ``state``
    must already lie on that device, and runs dense from the start, as in
    the reference (whose donated state makes a replay impossible).  When
    a compaction bucket overflows the scenario is replayed dense under a
    ``RuntimeWarning``; the results are bit-identical either way.  The run
    is the batch of one lane of :func:`simulate_batch`, squeezed."""
    dev = resolve_device(device)
    if params is None:
        params = CloudParams.for_spec(spec)
    _check_meter_params(spec, params)
    if state is not None:
        spec = dense_spec(spec)
        state = add_lane(state)
    res = _run_lanes(spec, _trace_lanes(trace, 1, dev),
                     lane_params(params, 1, dev), state, t_stop, dev)
    return drop_lane(res)


def simulate_batch(spec: CloudSpec, trace: Trace, params: CloudParams,
                   t_stop: float = math.inf, *, device=None) -> CloudResult:
    """Batched scenario sweep: every :class:`Trace` and :class:`CloudParams`
    leaf that carries a leading batch axis is a lane's own, the others
    broadcast (see :func:`stack_params` / :func:`stack_traces`).

    Returns a :class:`CloudResult` whose every leaf has the batch as its
    leading axis; lane ``i`` equals :func:`simulate` of lane ``i`` bit for
    bit.  The lanes run in the same passes, so each kernel launch of a
    pass serves all of them, and the host reads once a body for all.
    Raises ``ValueError`` when no leaf is batched or the batched leaves
    disagree on the batch size.  A compaction bucket that overflows in
    any lane replays the whole batch with ``compact=0`` under a
    ``RuntimeWarning`` (bit-identical results).  ``device`` as in
    :func:`simulate`."""
    dev = resolve_device(device)
    B = _batch_size(trace, params)
    _check_meter_params(spec, params)
    return _run_lanes(spec, _trace_lanes(trace, B, dev),
                      lane_params(params, B, dev), None, t_stop, dev)


def simulate_batch_sharded(spec: CloudSpec, trace: Trace,
                           params: CloudParams, t_stop: float = math.inf,
                           devices=None) -> CloudResult:
    """:func:`simulate_batch` with the lanes split over ``devices`` (a
    list of torch devices; ``None``: every visible card).  Each lane is
    bit-equal to the unsplit call.  Implemented in
    :mod:`repro_torch.experiments.shard` (imported here lazily: the engine
    does not depend on the experiments layer)."""
    from ..experiments.shard import simulate_batch_sharded as impl
    return impl(spec, trace, params, t_stop, devices)


# ---------------------------------------------------------------------------
# Streaming trace windows
# ---------------------------------------------------------------------------

class StreamCarry(NamedTuple):
    """The per-window carry of :func:`simulate_stream`.

    ``state`` is the ordinary :class:`CloudState` whose task axis is the
    fixed slot pool (``Q`` slots, never the total trace length); ``slots``
    is the slot-table :class:`Trace` those task indices resolve against.
    A free slot has ``gid == -1``, ``arrival == inf`` and ``task_state ==
    TASK_DONE``, which makes it inert in every queue, horizon and
    termination mask.  ``compact_ok`` is the compaction verdict of the
    windows so far (a host bool: the host loop reads it with the loop
    condition)."""

    state: CloudState
    slots: Trace
    compact_ok: bool


class StreamResult(NamedTuple):
    """:class:`CloudResult`-shaped result of a windowed replay: the
    per-task outputs on the global task axis (``T_total``), meters and
    state the final carried values, plus per-window progress curves.
    Every leaf of a batch leads with the lane axis."""

    state: CloudState
    completion: torch.Tensor   # f32[T_total] completion times (inf: unfinished)
    rejected: torch.Tensor     # bool[T_total]
    energy: torch.Tensor       # f32[P] (view of meters.pm)
    energy_sampled: torch.Tensor  # f32[P]
    meters: MeterState
    n_events: torch.Tensor
    t_end: torch.Tensor
    overflow: torch.Tensor
    window_t_end: torch.Tensor   # f32[n_windows] clock after each window
    window_energy: torch.Tensor  # f32[n_windows] total PM energy after each

    def readings(self, spec: CloudSpec) -> dict[str, torch.Tensor]:
        """Named energy readings of the stack, as
        :meth:`CloudResult.readings`."""
        return meter_readings(spec.meters, self.meters)


def default_n_slots(spec: CloudSpec, window: int) -> int:
    """Default slot-pool size: room for a full window of fresh arrivals on
    top of every VM the cloud can run at once (plus queue slack).
    Exhaustion is reported (``overflow``), never silent."""
    return max(2 * window, spec.n_vm + window)


def _init_stream_lanes(spec: CloudSpec, n_slots: int, params: LaneParams,
                       dev) -> StreamCarry:
    B, Q = params.pm_cores.shape[0], int(n_slots)
    slots = Trace(
        arrival=torch.full((B, Q), math.inf, dtype=torch.float32, device=dev),
        cores=torch.zeros((B, Q), dtype=torch.float32, device=dev),
        work=torch.zeros((B, Q), dtype=torch.float32, device=dev),
        gid=torch.full((B, Q), -1, dtype=torch.int32, device=dev))
    st = _init_lanes(spec, Q, params, dev)
    st = st._replace(task_state=torch.full((B, Q), TASK_DONE,
                                           dtype=torch.int8, device=dev))
    return StreamCarry(state=st, slots=slots, compact_ok=True)


def init_stream(spec: CloudSpec, n_slots: int,
                params: CloudParams | None = None, *,
                device=None) -> StreamCarry:
    """The streaming engine's initial carry of one scenario: an empty slot
    table and an :func:`init_state` whose every task slot is free (inert
    ``TASK_DONE``, ``arrival == inf``).  ``device`` as in
    :func:`simulate`."""
    dev = resolve_device(device)
    if params is None:
        params = CloudParams.for_spec(spec)
    _check_meter_params(spec, params)
    return drop_lane(_init_stream_lanes(spec, n_slots,
                                        lane_params(params, 1, dev), dev))


def _reached(t: torch.Tensor, mark: float) -> torch.Tensor:
    """bool[B]: ``isfinite(mark) & (t >= mark)`` for a host ``mark``."""
    if math.isfinite(mark):
        return t >= mark
    return torch.zeros(t.shape, dtype=torch.bool, device=t.device)


def _stream_step(spec: CloudSpec, carry: StreamCarry, window: Trace,
                 params: LaneParams, t_prev_next: float, t_next: float,
                 t_stop: torch.Tensor):
    """One window of the streaming engine, every lane of ``carry`` at once
    (``window``: one [W] gid-carrying :class:`Trace` on the carry's
    device, shared by the lanes; ``t_prev_next`` / ``t_next`` host
    floats).  Returns ``(carry, flush)``.

    1. *Insert*: the window's valid tasks (``gid >= 0``) scatter into the
       free slots of each lane in rank order (the i-th incoming task into
       the i-th free slot); an exhausted pool raises ``overflow`` and
       drops nothing silently.
    2. *Replay*: the previous window's loop ended on the hand-over pass,
       whose management stages were discarded (the monolithic engine ran
       them with the next arrival already queued); they run again now
       that the arrivals are present.  ``t_prev_next`` tells whether the
       previous loop ended on a hand-over (``t >= t_prev_next``) or on
       ``t_stop`` (no discarded pass, no replay).  A same-instant cohort
       split across the window boundary (``t >= t_next``) defers the
       pass, and the whole loop, again.  The choice is a select per lane,
       not a host read.
    3. *Loop*: the ordinary staged pipeline with the ``t_next`` sentinel
       in the horizon and the termination masks; it runs exactly the
       monolithic pass sequence up to the next hand-over.
    4. *Flush*: terminal slots emit ``(gid, t_done, rejected)`` and are
       freed for the next window.
    """
    st, slots = carry.state, carry.slots
    B, Q = slots.gid.shape
    dev = slots.gid.device

    # ---- 1. insert: rank-matched scatter of valid tasks into free slots
    free = slots.gid < 0
    free_rank = torch.cumsum(free, -1) - 1              # each free slot's rank
    slot_of_rank = scatter_drop(
        torch.full((B, Q), Q, dtype=torch.int64, device=dev),
        torch.where(free, free_rank, Q),
        torch.arange(Q, device=dev).expand(B, Q))
    valid = (window.gid >= 0).expand(B, window.n)
    pos = torch.cumsum(valid, -1) - 1                   # each task's rank
    take = valid & (pos < free.sum(-1, keepdim=True))
    dest = torch.where(take, slot_of_rank.gather(1, pos.clamp(0, Q - 1)), Q)
    slots = Trace(*(scatter_drop(old, dest, new)
                    for old, new in zip(slots, window)))
    st = st._replace(
        task_state=scatter_drop(st.task_state, dest, TASK_PENDING),
        task_vm=scatter_drop(st.task_vm, dest, -1),
        t_done=scatter_drop(st.t_done, dest, math.inf),
        overflow=st.overflow | (valid & ~take).any(-1))

    # ---- 2. gated management replay
    do_mp = _reached(st.t, t_prev_next) & ~_reached(st.t, t_next)
    stopped = torch.isfinite(t_stop) & (st.t >= t_stop)
    st = select_lanes(do_mp, loop.management_pass(spec, params, slots, st),
                      st)
    st = st._replace(running=do_mp & ~stopped)

    # ---- 3. the staged loop up to the next hand-over
    st, ok = _host_loop(
        spec, loop.make_body(spec, params, slots, t_stop, t_next), st)

    # ---- 4. flush terminal slots, free them
    rej = st.task_state == TASK_REJECTED
    term = ((st.task_state == TASK_DONE) | rej) & (slots.gid >= 0)
    flush = dict(gid=torch.where(term, slots.gid, -1),
                 t_done=torch.where(term, st.t_done, math.inf),
                 rejected=term & rej, t_end=st.t,
                 energy=lane_sum(st.meters.pm.energy))
    slots = Trace(arrival=torch.where(term, math.inf, slots.arrival),
                  cores=torch.where(term, 0.0, slots.cores),
                  work=torch.where(term, 0.0, slots.work),
                  gid=torch.where(term, -1, slots.gid))
    st = st._replace(task_state=torch.where(term, TASK_DONE, st.task_state),
                     task_vm=torch.where(term, -1, st.task_vm),
                     t_done=torch.where(term, math.inf, st.t_done))
    return StreamCarry(state=st, slots=slots,
                       compact_ok=carry.compact_ok and ok is not False), flush


_NP_TRACE = {"arrival": np.float32, "cores": np.float32, "work": np.float32,
             "gid": np.int32}


def _host_array(x, dtype) -> np.ndarray:
    """``x`` (array or tensor) as a numpy array on the host."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
    return np.asarray(x, dtype)


def _host_window(w: Trace) -> Trace:
    """``w`` as numpy arrays on the host (a device tensor is copied)."""
    return Trace(*(None if x is None else _host_array(x, _NP_TRACE[k])
                   for k, x in zip(Trace._fields, w)))


def _replayable(windows) -> bool:
    return hasattr(windows, "n_windows") and hasattr(windows, "window")


def _as_window_iter(windows, window_size=None):
    """``(iterator of gid-carrying host windows, W)`` from ``windows``: a
    :class:`~repro_torch.core.trace.WindowedTrace`, a sequence or a
    generator of :class:`Trace` windows (gid-carrying, or plain, which
    get sequential global ids in arrival order).  Windows must be
    time-sorted across the stream; ``chunk_trace`` guarantees it, a
    generator promises it.  Each window is held as numpy arrays, so its
    first arrival is read without a device read."""
    if _replayable(windows):
        seq = (_host_window(windows.window(k))
               for k in range(windows.n_windows))
        return seq, int(windows.window_size)

    def gen():
        offset = 0
        W = window_size
        for w in windows:
            w = _host_window(w)
            if w.gid is None:
                w = w._replace(gid=np.arange(offset, offset + w.n,
                                             dtype=np.int32))
                offset += w.n
            if W is not None and w.n != W:
                if w.n > W:
                    raise ValueError(
                        f"window of {w.n} tasks exceeds the stream's "
                        f"window size {W}; all windows must share one "
                        f"shape (pad the last window, as chunk_trace does)")
                pad = W - w.n
                w = Trace(*(np.concatenate([x, np.full((pad,), fill,
                                                       x.dtype)])
                            for x, fill in zip(w, (np.inf, 0.0, 0.0, -1))))
            yield w

    return gen(), window_size


def _chain_one(first, rest):
    yield first
    yield from rest


def _first_arrival(w: Trace) -> float:
    """The window's first valid arrival (a host float, exact in f32): the
    ``t_next`` sentinel.  Windows are time-sorted, so this is the minimum
    the monolithic horizon takes over every arrival not yet loaded."""
    valid = w.gid >= 0
    return float(w.arrival[valid].min()) if valid.any() else math.inf


def _stream_shards(spec: CloudSpec, windows, shards, n_slots, t_stop):
    """Replay ``windows`` through every shard of ``shards`` (a list of
    ``(LaneParams, device)``), window by window, so that a generator is
    read once.  Returns ``(results, ok)``: one lane-axis
    :class:`StreamResult` a shard, or ``(None, False)`` when a compaction
    bucket overflowed (the replay stops there)."""
    it, W = _as_window_iter(windows)
    cur = next(it, None)
    if cur is None:
        raise ValueError("simulate_stream needs at least one window")
    if W is None:        # generator input: the first window fixes the shape
        it, _ = _as_window_iter(_chain_one(cur, it), window_size=cur.n)
        cur = next(it)
    Q = default_n_slots(spec, cur.n) if n_slots is None else int(n_slots)
    carries = [_init_stream_lanes(spec, Q, p, dev) for p, dev in shards]
    t_stops = [torch.full((p.pm_cores.shape[0],), t_stop,
                          dtype=torch.float32, device=dev)
               for p, dev in shards]
    flushes = [[] for _ in shards]
    # t_prev_next = 0 makes the first step run the monolithic pre-loop
    # management pass (the clock starts at 0 >= 0)
    t_prev_next = 0.0
    while cur is not None:
        nxt = next(it, None)
        t_next = math.inf if nxt is None else _first_arrival(nxt)
        for i, (p, dev) in enumerate(shards):
            window = Trace(*(torch.from_numpy(x).to(dev) for x in cur))
            carries[i], flush = _stream_step(spec, carries[i], window, p,
                                             t_prev_next, t_next, t_stops[i])
            if not carries[i].compact_ok:
                return None, False
            flushes[i].append(flush)
        t_prev_next, cur = t_next, nxt
    # the global task count, from every flushed and live gid: one read a
    # shard
    n_total = 1 + max(
        int(torch.cat([f["gid"] for f in fl] + [c.slots.gid], -1).max())
        for c, fl in zip(carries, flushes))
    return [_assemble_stream(c, fl, n_total)
            for c, fl in zip(carries, flushes)], True


def _assemble_stream(carry: StreamCarry, flushes: list[dict],
                     n_total: int) -> StreamResult:
    """Scatter the per-window flushes back onto the global task axis."""
    gids = torch.cat([f["gid"] for f in flushes], dim=-1)
    idx = torch.where(gids >= 0, gids, n_total)
    B = gids.shape[0]
    dev = gids.device
    completion = scatter_drop(
        torch.full((B, n_total), math.inf, dtype=torch.float32, device=dev),
        idx, torch.cat([f["t_done"] for f in flushes], dim=-1))
    rejected = scatter_drop(
        torch.zeros((B, n_total), dtype=torch.bool, device=dev), idx,
        torch.cat([f["rejected"] for f in flushes], dim=-1))
    st = carry.state
    return StreamResult(
        state=st,
        completion=completion,
        rejected=rejected,
        energy=st.meters.pm.energy,
        energy_sampled=st.meters.pm_sampled,
        meters=st.meters,
        n_events=st.n_events,
        t_end=st.t,
        overflow=st.overflow,
        window_t_end=torch.stack([f["t_end"] for f in flushes], dim=-1),
        window_energy=torch.stack([f["energy"] for f in flushes], dim=-1),
    )


def _run_stream(spec: CloudSpec, windows, shards, n_slots,
                t_stop) -> list[StreamResult]:
    """:func:`_stream_shards`, replayed dense (under a ``RuntimeWarning``)
    when a compaction bucket overflowed.  A replayable window source
    (``WindowedTrace``) restarts the whole stream: the carried state
    already consumed compacted windows, so a switch mid-stream would not
    be bit-identical.  A consumed generator cannot be replayed: that
    raises ``RuntimeError``."""
    res, ok = _stream_shards(spec, windows, shards, n_slots, t_stop)
    if ok:
        return res
    if _replayable(windows):
        _warn_dense_rerun(spec, shards[0][1])
        return _stream_shards(dense_spec(spec), windows, shards, n_slots,
                              t_stop)[0]
    raise RuntimeError(
        "active-set compaction bucket overflowed mid-stream and the "
        "window source is a consumed generator that cannot be replayed; "
        "rerun with spec.compact=0 (dense) or pass a replayable "
        "WindowedTrace")


def simulate_stream(spec: CloudSpec, windows,
                    params: CloudParams | None = None, *,
                    n_slots: int | None = None, t_stop: float = math.inf,
                    device=None) -> StreamResult:
    """Replay a windowed trace window by window, bit-identical to
    :func:`simulate` on the concatenated trace, with a task axis of
    ``n_slots`` slots instead of the total trace length.

    ``windows`` is a :class:`repro_torch.core.trace.WindowedTrace` (from
    ``chunk_trace``), or any sequence or generator of time-sorted
    :class:`Trace` windows (e.g.
    :func:`repro_torch.data.pipeline.gwa_window_stream`: the full trace
    is never held).  ``n_slots`` bounds the tasks live at once (default
    :func:`default_n_slots`); exhaustion sets ``overflow``.  The run is
    the stream batch of one lane
    (:func:`repro_torch.experiments.shard.simulate_stream_batch`),
    squeezed.  ``device`` as in :func:`simulate`."""
    dev = resolve_device(device)
    if params is None:
        params = CloudParams.for_spec(spec)
    _check_meter_params(spec, params)
    res = _run_stream(spec, windows, [(lane_params(params, 1, dev), dev)],
                      n_slots, t_stop)
    return drop_lane(res[0])


def start_migration(spec: CloudSpec, params: CloudParams, st: CloudState,
                    v, dst) -> CloudState:
    """Begin live-migrating VM slot ``v`` to PM ``dst`` (paper Fig. 6).

    The out-of-loop shim over the masked-migration primitive
    (:func:`repro_torch.core.loop.migrate.migrate_one`) that the in-loop
    policies ``consolidate`` / ``defrag`` / ``evacuate`` issue too, on one
    scenario's state.  The caller must ensure the destination fits; cores
    move src -> dst at once.  ``v`` and ``dst`` may be numbers or tensors
    on ``st``'s device."""
    from .loop.migrate import migrate_one
    dev = st.running.device
    lanes = add_lane(st)
    true = torch.ones((1,), dtype=torch.bool, device=dev)
    out = migrate_one(spec, lane_params(params, 1, dev), lanes,
                      torch.as_tensor(v, device=dev),
                      torch.as_tensor(dst, device=dev), true)
    return drop_lane(out._replace(running=true))


def make_allocation(spec: CloudSpec, st: CloudState, pm, cores, expiry
                    ) -> tuple[CloudState, torch.Tensor]:
    """Reserve ``cores`` on ``pm`` as an allocation that expires at
    ``expiry`` (§3.4.2).  Returns ``(state, VM slot)``, the slot -1 when
    no slot is free, the PM is not running or lacks the cores."""
    dev = st.vstage.device
    P, V = spec.n_pm, spec.n_vm
    pm = torch.as_tensor(pm, device=dev).reshape(1).long()
    cores = torch.as_tensor(cores, dtype=torch.float32, device=dev).reshape(1)
    expiry = torch.as_tensor(expiry, dtype=torch.float32,
                             device=dev).reshape(1)
    vfree = st.vstage == mc.VM_FREE
    v = torch.argmax(vfree.to(torch.int8), dim=0, keepdim=True)  # first free
    ok = (vfree.any() & (st.free_cores[pm] >= cores)
          & (st.pstate[pm] == PM_RUNNING))
    on_v = (torch.arange(V, device=dev) == v) & ok
    on_pm = torch.arange(P, device=dev) == pm
    true = torch.ones((), dtype=torch.bool, device=dev)
    st = st._replace(
        vstage=torch.where(on_v, mc.VM_ALLOCATED, st.vstage),
        vm_host=torch.where(on_v, pm.to(st.vm_host.dtype), st.vm_host),
        vm_cores=torch.where(on_v, cores, st.vm_cores),
        vm_expiry=torch.where(on_v, expiry, st.vm_expiry),
        free_cores=torch.where(
            on_pm, st.free_cores + torch.where(ok, -cores, 0.0),
            st.free_cores),
        running=true,
    )
    return st, torch.where(ok, v, -1).to(torch.int32)[0]


# ---------------------------------------------------------------------------
# Carrying state across from numpy (keys: the reference's dotted field names)
# ---------------------------------------------------------------------------

def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def params_from_numpy(flat: dict) -> CloudParams:
    """:class:`CloudParams` from ``{"pm_cores": ..., "power.p_min": ...,
    "meter.indirect_base": ...}``; scalars become host numbers, the power
    table and meter coefficients CPU tensors.  A batched scalar (an array
    with a leading batch axis) becomes a CPU tensor: f32, or int32 codes."""
    kw = {}
    for f in dataclasses.fields(CloudParams):
        if f.name in ("power", "meter"):
            continue
        value = np.asarray(flat[f.name])
        code = f.name in ("vm_sched", "pm_sched")
        if value.ndim:
            kw[f.name] = _tensor(value.astype(np.int32 if code
                                              else np.float32), "cpu")
        else:
            kw[f.name] = int(value) if code else float(value)
    kw["power"] = PowerStateTable(*(_tensor(flat[f"power.{k}"], "cpu")
                                    for k in PowerStateTable._fields))
    kw["meter"] = MeterParams(
        indirect_base=_tensor(flat["meter.indirect_base"], "cpu"),
        indirect_coeff=_tensor(flat["meter.indirect_coeff"], "cpu"))
    return CloudParams(**kw)


def trace_from_numpy(flat: dict, device=None) -> Trace:
    """:class:`Trace` tensors from ``{"arrival", "cores", "work"}`` and,
    for a window, ``"gid"`` (int32)."""
    dev = resolve_device(device)
    return Trace(*(_tensor(np.asarray(flat[k], np.int32 if k == "gid"
                                      else np.float32), dev)
                   if k in flat or k != "gid" else None
                   for k in Trace._fields))


def _from_flat(cls, flat: dict, prefix: str, device):
    fields = {}
    for name in cls._fields:
        key = f"{prefix}{name}"
        sub = {MeterState: {"pm": MeterAccum, "vm": MeterAccum,
                            "group": MeterAccum, "total": MeterAccum,
                            "indirect": MeterAccum, "pm_idle": MeterAccum},
               CloudState: {"meters": MeterState}}.get(cls, {}).get(name)
        fields[name] = (_from_flat(sub, flat, key + ".", device) if sub
                        else _tensor(flat[key], device))
    return cls(**fields)


def state_from_numpy(flat: dict, device=None) -> CloudState:
    """:class:`CloudState` from ``{"t": ..., "meters.pm.energy_hi": ...}``,
    keeping each array's dtype (int8 enums, int32 indices)."""
    return _from_flat(CloudState, flat, "", resolve_device(device))


def to_numpy(obj, prefix: str = "") -> dict[str, np.ndarray]:
    """Flatten a port object (NamedTuple / dataclass tree of tensors and
    numbers) into ``{dotted field name: numpy array}``."""
    if torch.is_tensor(obj):
        return {prefix: obj.detach().cpu().numpy()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        items = zip(obj._fields, obj)
    elif dataclasses.is_dataclass(obj):
        items = ((f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj))
    elif obj is None:
        return {}
    else:
        return {prefix: np.asarray(obj)}
    out = {}
    for name, value in items:
        out.update(to_numpy(value, f"{prefix}.{name}" if prefix else name))
    return out
