"""Energy modelling (paper §3.3): power states, consumption models and the
meter stack (port of ``repro.core.energy``).

:class:`MeterTopology` is static (which meters exist), :class:`MeterParams`
holds the meter coefficients as tensors, :class:`MeterState` the running
readings carried through the event loop.  Every event horizon the engine
builds one :class:`SimView` and calls :func:`observe`, which integrates power
exactly over the piecewise-constant interval.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


def kahan_add(hi: torch.Tensor, lo: torch.Tensor, x: torch.Tensor):
    """One compensated-summation step: ``(hi, lo) += x``."""
    y = x - lo
    hi2 = hi + y
    lo2 = (hi2 - hi) - y
    return hi2, lo2


# Power states of a physical machine (paper Table 1/2 + Fig. 5)
PM_OFF = 0
PM_SWITCHING_ON = 1
PM_RUNNING = 2
PM_SWITCHING_OFF = 3
N_PM_STATES = 4

# Consumption-model kinds
MODEL_CONSTANT = 0   # P = p_min
MODEL_LINEAR = 1     # P = p_min + u * (p_max - p_min)


def _f32(values, device="cpu") -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


class PowerStateTable(NamedTuple):
    """Per power-state consumption model: tensors of shape [N_PM_STATES]."""

    mode: torch.Tensor      # i32 — MODEL_CONSTANT / MODEL_LINEAR
    p_min: torch.Tensor     # f32 watts
    p_max: torch.Tensor     # f32 watts
    duration: torch.Tensor  # f32 seconds a transitional state lasts

    @staticmethod
    def simple(off_w: float = 36.4, on_w: float = 483.1, min_w: float = 368.8,
               max_w: float = 722.7, off_w2: float = 409.2,
               boot_s: float = 200.0, shutdown_s: float = 12.0,
               ) -> "PowerStateTable":
        """Paper Table 1 — the measured Innsbruck cloud node."""
        return PowerStateTable(
            mode=torch.tensor([MODEL_CONSTANT, MODEL_CONSTANT, MODEL_LINEAR,
                               MODEL_CONSTANT], dtype=torch.int32),
            p_min=_f32([off_w, on_w, min_w, off_w2]),
            p_max=_f32([off_w, on_w, max_w, off_w2]),
            duration=_f32([0.0, boot_s, 0.0, shutdown_s]),
        )

    @staticmethod
    def complex_model(off_w: float = 36.4, min_w: float = 368.8,
                      max_w: float = 722.7, boot_s: float = 200.0,
                      shutdown_s: float = 12.0) -> "PowerStateTable":
        """Paper Table 2 — transitional states are linear too."""
        return PowerStateTable(
            mode=torch.tensor([MODEL_CONSTANT, MODEL_LINEAR, MODEL_LINEAR,
                               MODEL_LINEAR], dtype=torch.int32),
            p_min=_f32([off_w, min_w, min_w, min_w]),
            p_max=_f32([off_w, max_w, max_w, max_w]),
            duration=_f32([0.0, boot_s, 0.0, shutdown_s]),
        )

    def to(self, device) -> "PowerStateTable":
        return PowerStateTable(*(x.to(device) for x in self))


def instantaneous_power(table: PowerStateTable, state: torch.Tensor,
                        utilisation: torch.Tensor) -> torch.Tensor:
    """Direct-meter power estimate per PM (W)."""
    s = state.long()
    mode = table.mode[s]
    p_min = table.p_min[s]
    p_max = table.p_max[s]
    u = torch.clamp(utilisation, 0.0, 1.0)
    linear = p_min + u * (p_max - p_min)
    return torch.where(mode == MODEL_LINEAR, linear, p_min)


def vm_power_attribution(pm_power, pm_idle, pm_span, pm_util, vm_rate_frac,
                         vm_host, vms_on_host) -> torch.Tensor:
    """Adjusted-aggregation VM power (paper Eq. 6)."""
    host = torch.clamp(vm_host, min=0).long()
    hosted = vm_host >= 0
    variable = pm_span[host] * pm_util[host] * vm_rate_frac
    idle_share = pm_idle[host] / torch.clamp(vms_on_host[host], min=1).to(
        torch.float32)
    return torch.where(hosted, variable + idle_share, 0.0)


class MeterAccum(NamedTuple):
    """Kahan-compensated energy accumulator (J) plus the last power."""

    energy_hi: torch.Tensor
    energy_lo: torch.Tensor
    last_power: torch.Tensor

    @staticmethod
    def zero(shape=(), device="cpu") -> "MeterAccum":
        def z():
            return torch.zeros(shape, dtype=torch.float32, device=device)
        return MeterAccum(z(), z(), z())

    def integrate(self, power: torch.Tensor, dt: torch.Tensor) -> "MeterAccum":
        hi, lo = kahan_add(self.energy_hi, self.energy_lo, power * dt)
        return MeterAccum(hi, lo, power)

    @property
    def energy(self) -> torch.Tensor:
        return self.energy_hi


# Signals an indirect meter may be driven by (paper §3.3.1).
SIGNAL_IT_POWER = 0
SIGNAL_VM_COUNT = 1
SIGNAL_QUEUE_LEN = 2
N_SIGNALS = 3


@dataclasses.dataclass(frozen=True)
class IndirectMeterSpec:
    """One indirect meter: ``P = base_w + coeff * signal``."""

    name: str
    signal: int = SIGNAL_IT_POWER
    base_w: float = 0.0
    coeff: float = 0.0


def hvac_spec(pue_minus_one: float = 0.58, base_w: float = 0.0,
              name: str = "hvac") -> IndirectMeterSpec:
    """Data-centre cooling riding the IT-power signal (PUE-style)."""
    return IndirectMeterSpec(name=name, signal=SIGNAL_IT_POWER,
                             base_w=base_w, coeff=pue_minus_one)


@dataclasses.dataclass(frozen=True)
class MeterTopology:
    """Static description of the meter stack (which meters exist)."""

    vm_direct: bool = True
    pm_groups: tuple[tuple[int, ...], ...] = ()
    indirect: tuple[IndirectMeterSpec, ...] = (hvac_spec(),)

    def __post_init__(self):
        names = [m.name for m in self.indirect]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate indirect meter names: {names}")
        reserved = {"pm", "pm_idle", "pm_sampled", "iaas_total", "vm",
                    "vm_unattributed"}
        reserved |= {f"group{g}" for g in range(len(self.pm_groups))}
        clash = reserved & set(names)
        if clash:
            raise ValueError(f"indirect meter name(s) {sorted(clash)} collide "
                             f"with built-in meter_readings keys")

    @property
    def n_groups(self) -> int:
        return len(self.pm_groups)

    @property
    def n_indirect(self) -> int:
        return len(self.indirect)

    def group_matrix(self, n_pm: int) -> np.ndarray:
        """f32[G, P] membership matrix of the hierarchical aggregators."""
        member = np.zeros((self.n_groups, n_pm), np.float32)
        for g, pms in enumerate(self.pm_groups):
            for p in pms:
                if not 0 <= p < n_pm:
                    raise ValueError(f"pm_groups[{g}] references PM {p} "
                                     f"outside 0..{n_pm - 1}")
                member[g, p] = 1.0
        return member

    def signal_index(self) -> list[int]:
        return [m.signal for m in self.indirect]


@dataclasses.dataclass(frozen=True)
class MeterParams:
    """Meter coefficients: ``f32[K]`` tensors, one entry per indirect meter."""

    indirect_base: torch.Tensor = None
    indirect_coeff: torch.Tensor = None

    @classmethod
    def for_topology(cls, topology: MeterTopology, **overrides
                     ) -> "MeterParams":
        kw = dict(indirect_base=_f32([m.base_w for m in topology.indirect]),
                  indirect_coeff=_f32([m.coeff for m in topology.indirect]))
        kw.update(overrides)
        return cls(**kw)

    def to(self, device) -> "MeterParams":
        return MeterParams(
            indirect_base=torch.as_tensor(self.indirect_base,
                                          dtype=torch.float32).to(device),
            indirect_coeff=torch.as_tensor(self.indirect_coeff,
                                           dtype=torch.float32).to(device))


class MeterState(NamedTuple):
    """Accumulated readings of the whole stack."""

    pm: MeterAccum          # [P] per-PM direct meters (exact integral)
    pm_sampled: torch.Tensor  # f32[P] the paper's polled meter (§3.3.2)
    vm: MeterAccum          # [V] per-VM Eq. 6 adjusted aggregation ([0] if off)
    group: MeterAccum       # [G] hierarchical PM-group aggregators
    total: MeterAccum       # []  whole-IaaS aggregate
    indirect: MeterAccum    # [K] indirect meters
    pm_idle: MeterAccum     # [P] per-PM idle-component draw

    @staticmethod
    def zero(topology: MeterTopology, n_pm: int, n_vm: int,
             device="cpu") -> "MeterState":
        return MeterState(
            pm=MeterAccum.zero((n_pm,), device),
            pm_sampled=torch.zeros((n_pm,), dtype=torch.float32,
                                   device=device),
            vm=MeterAccum.zero((n_vm if topology.vm_direct else 0,), device),
            group=MeterAccum.zero((topology.n_groups,), device),
            total=MeterAccum.zero((), device),
            indirect=MeterAccum.zero((topology.n_indirect,), device),
            pm_idle=MeterAccum.zero((n_pm,), device),
        )


class SimView(NamedTuple):
    """The engine's observation surface for one event-horizon interval."""

    pm_power: torch.Tensor     # f32[P] instantaneous draw (W)
    pm_idle: torch.Tensor      # f32[P] state-dependent idle draw
    pm_span: torch.Tensor      # f32[P] p_max - p_min on linear states, else 0
    pm_util: torch.Tensor      # f32[P] delivered / capacity
    vm_rate_frac: torch.Tensor  # f32[V]
    vm_host: torch.Tensor      # i32[V] hosting PM, -1 when uncoupled
    vms_on_host: torch.Tensor  # i32[P] |G(s_vm)| - 1 per host (Eq. 6 divisor)
    n_hosted: torch.Tensor     # f32    SIGNAL_VM_COUNT
    n_queued: torch.Tensor     # f32    SIGNAL_QUEUE_LEN
    tick: torch.Tensor         # bool   sampled-meter tick fired this interval
    period: torch.Tensor       # f32    sampling period (s)


def observe(topology: MeterTopology, mparams: MeterParams, view: SimView,
            dt: torch.Tensor, meters: MeterState) -> MeterState:
    """Advance the whole meter stack over one event-horizon interval."""
    pm = meters.pm.integrate(view.pm_power, dt)
    pm_sampled = meters.pm_sampled + torch.where(
        view.tick, view.pm_power * view.period, 0.0)
    pm_idle = meters.pm_idle.integrate(view.pm_idle, dt)

    it_power = torch.sum(view.pm_power)
    total = meters.total.integrate(it_power, dt)

    if topology.vm_direct:
        vm_power = vm_power_attribution(
            view.pm_power, view.pm_idle, view.pm_span, view.pm_util,
            view.vm_rate_frac, view.vm_host, view.vms_on_host)
        vm = meters.vm.integrate(vm_power, dt)
    else:
        vm = meters.vm

    if topology.n_groups:
        member = torch.from_numpy(topology.group_matrix(
            view.pm_power.shape[-1])).to(view.pm_power.device)
        group = meters.group.integrate(member @ view.pm_power, dt)
    else:
        group = meters.group

    if topology.n_indirect:
        signals = torch.stack([it_power, view.n_hosted, view.n_queued])
        drive = signals[topology.signal_index()]
        ind_power = mparams.indirect_base + mparams.indirect_coeff * drive
        indirect = meters.indirect.integrate(ind_power, dt)
    else:
        indirect = meters.indirect

    return MeterState(pm=pm, pm_sampled=pm_sampled, vm=vm, group=group,
                      total=total, indirect=indirect, pm_idle=pm_idle)


def meter_readings(topology: MeterTopology, meters: MeterState
                   ) -> dict[str, torch.Tensor]:
    """Named energy readings (J) of a :class:`MeterState`."""
    out = {
        "pm": meters.pm.energy,
        "pm_idle": meters.pm_idle.energy,
        "pm_sampled": meters.pm_sampled,
        "iaas_total": meters.total.energy,
    }
    if topology.vm_direct:
        out["vm"] = meters.vm.energy
        out["vm_unattributed"] = (meters.total.energy
                                  - torch.sum(meters.vm.energy, dim=-1))
    for g, _pms in enumerate(topology.pm_groups):
        out[f"group{g}"] = meters.group.energy[..., g]
    for k, m in enumerate(topology.indirect):
        out[m.name] = meters.indirect.energy[..., k]
    return out
