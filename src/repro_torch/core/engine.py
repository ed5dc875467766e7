"""The IaaS cloud engine (paper §3.1-§3.5 in one event loop), port of
``repro.core.engine``'s single-scenario path.

* :class:`CloudSpec` — shapes, topology and algorithm choices.  The
  reference's ``backend`` switch has no counterpart: the device of the
  tensors picks the hand-written kernels (CUDA) or their plain versions
  (CPU).
* :class:`CloudParams` — every continuous knob plus the VM/PM policy codes.
* :func:`simulate` — runs a trace to completion and returns a
  :class:`CloudResult`.  The staged pipeline (:mod:`repro_torch.core.loop`)
  runs from the host; the host reads the loop condition once per body.

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
from .loop.state import BIG as _BIG, TASK_PENDING, TASK_REJECTED, CloudState

__all__ = ["CloudSpec", "CloudParams", "CloudState", "CloudResult", "Trace",
           "make_cloud", "init_state", "simulate", "params_from_numpy",
           "trace_from_numpy", "state_from_numpy", "to_numpy"]


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
    compact: int = -1            # -1 auto and 0 run the dense path
    steps_per_iter: int = 0      # passes per host check (0 = default)

    def __post_init__(self):
        if self.scheduler not in SCHEDULERS:
            raise ValueError(f"unknown sharing scheduler {self.scheduler!r}; "
                             f"registered: {sorted(SCHEDULERS)}")
        if self.compact < -1:
            raise ValueError(f"spec.compact must be -1 (auto), 0 (off) or a "
                             f"positive bucket size, got {self.compact}")
        if self.compact > 0:
            raise NotImplementedError(
                "active-set compaction (compact > 0) is not ported to "
                "repro_torch yet (ROADMAP.md queue 1 item 9); compact=-1 and "
                "compact=0 run the dense path, which the reference defines "
                "as the bit-identical replay target")
        if self.steps_per_iter < 0:
            raise ValueError(f"spec.steps_per_iter must be >= 0, got "
                             f"{self.steps_per_iter}")

    @property
    def layout(self) -> mc.SpreaderLayout:
        return mc.SpreaderLayout(self.n_pm, self.n_vm)


def _sched_code(value, layer: str) -> int:
    """A scheduler name or code as its registered integer code."""
    names = _policy_registry.names(layer)
    if isinstance(value, str):
        if value not in names:
            raise ValueError(f"unknown scheduler {value!r}; one of {names}")
        return names.index(value)
    code = int(value)
    if not 0 <= code < len(names):
        raise ValueError(f"scheduler code {code} out of range; "
                         f"0..{len(names) - 1} index {names}")
    return code


@dataclasses.dataclass(frozen=True)
class CloudParams:
    """Continuous cloud parameters (host numbers) and the policy codes.

    ``power`` and ``meter`` hold tensors; :func:`simulate` moves them to the
    run's device."""

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

    def to(self, device) -> "CloudParams":
        return dataclasses.replace(self, power=self.power.to(device),
                                   meter=self.meter.to(device))


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


class Trace(NamedTuple):
    """Task trace: one VM request per task (paper §4.2.2 protocol).  The
    generators in :mod:`repro_torch.core.trace` fill it with numpy arrays;
    :meth:`to` gives the device tensors the engine runs on."""

    arrival: object  # f32[T] submission times
    cores: object    # f32[T]
    work: object     # f32[T] total processing units

    @property
    def n(self) -> int:
        return self.arrival.shape[0]

    def to(self, device) -> "Trace":
        return Trace(*(torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                                       else x, dtype=torch.float32)
                       .to(device) for x in self))


class CloudResult(NamedTuple):
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
        """Named energy readings of the stack."""
        return meter_readings(spec.meters, self.meters)


def _check_meter_params(spec: CloudSpec, params: CloudParams) -> None:
    K = spec.meters.n_indirect
    for name in ("indirect_base", "indirect_coeff"):
        shape = tuple(torch.as_tensor(getattr(params.meter, name)).shape)
        if shape[-1:] != (K,):
            raise ValueError(f"CloudParams.meter.{name} has shape {shape} but "
                             f"spec.meters declares {K} indirect meter(s)")


def init_state(spec: CloudSpec, trace: Trace,
               params: CloudParams | None = None, *,
               device=None) -> CloudState:
    dev = resolve_device(device)
    if params is None:
        params = CloudParams.for_spec(spec)
    _check_meter_params(spec, params)
    P, V, T = spec.n_pm, spec.n_vm, trace.n
    F = V + P

    def full(n, value, dtype):
        return torch.full((n,), value, dtype=dtype, device=dev)

    def scalar(value, dtype=torch.float32):
        return torch.tensor(value, dtype=dtype, device=dev)

    start_running = params.pm_sched in _policy_registry.start_running_codes()
    period = params.metering_period
    return CloudState(
        t=scalar(0.0), t_c=scalar(0.0), n_events=scalar(0, torch.int32),
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
        pstate=full(P, PM_RUNNING if start_running else PM_OFF, torch.int8),
        pstate_end=full(P, math.inf, torch.float32),
        free_cores=full(P, params.pm_cores, torch.float32),
        meters=MeterState.zero(spec.meters, P, V, device=dev),
        meter_next=scalar(period if period > 0 else math.inf),
        processed=full(spec.layout.S, 0.0, torch.float32),
        overflow=scalar(False, torch.bool),
        running=scalar(True, torch.bool),
    )


def simulate(spec: CloudSpec, trace: Trace,
             params: CloudParams | None = None,
             state: CloudState | None = None,
             t_stop: float = math.inf, *, device=None) -> CloudResult:
    """Run the cloud to completion (or ``t_stop``).

    ``device=None`` runs on CUDA and raises when no card is present;
    ``device="cpu"`` runs the plain PyTorch path.  A caller's ``state``
    must already lie on that device."""
    dev = resolve_device(device)
    if params is None:
        params = CloudParams.for_spec(spec)
    params = params.to(dev)
    trace = trace.to(dev)
    st = init_state(spec, trace, params, device=dev) if state is None else state
    st = loop.management_pass(spec, params, trace, st)
    t_stop = torch.tensor(t_stop, dtype=torch.float32, device=dev)
    body = loop.make_body(spec, params, trace, t_stop)
    while bool(st.running & (st.n_events < spec.max_events)):
        st = body(st)
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
    )


# ---------------------------------------------------------------------------
# Carrying state across from numpy (keys: the reference's dotted field names)
# ---------------------------------------------------------------------------

def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def params_from_numpy(flat: dict) -> CloudParams:
    """:class:`CloudParams` from ``{"pm_cores": ..., "power.p_min": ...,
    "meter.indirect_base": ...}``; scalars become host numbers, the power
    table and meter coefficients CPU tensors."""
    kw = {}
    for f in dataclasses.fields(CloudParams):
        if f.name in ("power", "meter"):
            continue
        value = np.asarray(flat[f.name])
        kw[f.name] = (int(value) if f.name in ("vm_sched", "pm_sched")
                      else float(value))
    kw["power"] = PowerStateTable(*(_tensor(flat[f"power.{k}"], "cpu")
                                    for k in PowerStateTable._fields))
    kw["meter"] = MeterParams(
        indirect_base=_tensor(flat["meter.indirect_base"], "cpu"),
        indirect_coeff=_tensor(flat["meter.indirect_coeff"], "cpu"))
    return CloudParams(**kw)


def trace_from_numpy(flat: dict, device=None) -> Trace:
    """:class:`Trace` tensors from ``{"arrival", "cores", "work"}``."""
    dev = resolve_device(device)
    return Trace(*(_tensor(np.asarray(flat[k], np.float32), dev)
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
