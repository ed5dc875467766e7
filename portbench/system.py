"""The system under test, seen from the benchmark: the PyTorch and CUDA
port's experiment entry ``repro_torch.experiments.shard.run_batch``.

This is the one module of the benchmark that imports the port.  It turns
a configuration and a call's lanes and traces into the port's
``CloudSpec`` / ``CloudParams`` / ``Trace``, runs one sweep call, and
brings its answers back to the host as NumPy arrays.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.energy import (MeterParams, MeterTopology,
                                     IndirectMeterSpec, PowerStateTable,
                                     MODEL_CONSTANT, MODEL_LINEAR,
                                     SIGNAL_IT_POWER)
from repro_torch.experiments import shard

STATES = ("off", "switching_on", "running", "switching_off")
SIGNALS = {"it_power": SIGNAL_IT_POWER}


def topology(config: dict) -> MeterTopology:
    meters = config["meters"]
    return MeterTopology(
        vm_direct=bool(meters["vm_direct"]),
        indirect=tuple(IndirectMeterSpec(name=m["name"],
                                         signal=SIGNALS[m["signal"]],
                                         base_w=m["base_w"], coeff=m["coeff"])
                       for m in meters["indirect"]))


def spec(config: dict) -> engine.CloudSpec:
    return engine.CloudSpec(
        n_pm=int(config["n_pm"]), n_vm=int(config["n_vm"]),
        scheduler=config["scheduler"], max_events=int(config["max_events"]),
        max_fill_iters=int(config["max_fill_iters"]),
        max_migrations=int(config["max_migrations"]),
        compact=int(config["compact"]), meters=topology(config))


def power_table(config: dict) -> PowerStateTable:
    power = config["power"]
    rows = [power[s] for s in STATES]

    def f32(key):
        return torch.tensor([r[key] for r in rows], dtype=torch.float32)

    return PowerStateTable(
        mode=torch.tensor([MODEL_LINEAR if r["linear"] else MODEL_CONSTANT
                           for r in rows], dtype=torch.int32),
        p_min=f32("p_min"), p_max=f32("p_max"), duration=f32("seconds"))


def params(config: dict, lanes) -> engine.CloudParams:
    """The lanes' points stacked into one batch of ``CloudParams``."""
    table = power_table(config)
    meter = MeterParams.for_topology(topology(config))
    return engine.stack_params([
        engine.CloudParams(**lane.point, power=table, meter=meter)
        for lane in lanes])


def trace(traces: list[dict], lanes) -> engine.Trace:
    """One trace broadcast to every lane, or each lane's own stacked."""
    if len(traces) == 1:
        return engine.Trace(**traces[0])
    return engine.stack_traces([engine.Trace(**traces[lane.trace])
                                for lane in lanes])


class Sweep:
    """One cell's system: the spec, the stacked params (built once), and
    the device the calls run on."""

    def __init__(self, config: dict, lanes, device):
        self.spec = spec(config)
        self.params = params(config, lanes)
        self.lanes = lanes
        self.device = torch.device(device)

    def call(self, traces: list[dict], t_stop: float = math.inf):
        """One sweep call through ``run_batch``; the result on the device."""
        return shard.run_batch(self.spec, trace(traces, self.lanes),
                               self.params, t_stop=t_stop,
                               devices=[self.device])

    def answers(self, res) -> dict:
        """A call's answers as NumPy arrays, one row a lane."""
        out = dict(completion=res.completion, rejected=res.rejected,
                   n_events=res.n_events, t_end=res.t_end,
                   overflow=res.overflow, task_vm=res.state.task_vm)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        out["readings"] = {k: v.cpu().numpy()
                           for k, v in res.readings(self.spec).items()}
        return out

    def synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class KernelInputs:
    """A rerun's record of what each launch of the two main-path kernels
    was given (lanes, flows, live flows, touched spreaders; lanes and
    candidates), for the roofline shares.  Inside the ``with`` block the
    two kernels' entry points are wrapped; the counts stay on the device
    until the block ends."""

    def __enter__(self):
        from repro_torch.core.loop import advance
        from repro_torch.kernels import maxmin

        self._solve0, self._min0 = maxmin.maxmin_solve, advance.masked_min
        self._solve, self._min = [], []
        solve0, min0 = self._solve0, self._min0

        def solve(provider, consumer, p_l, live, perf, **kw):
            lv = live if live.dim() > 1 else live[None]
            S = perf.shape[-1]
            ends = torch.cat([torch.where(lv, provider.view(lv.shape), S),
                              torch.where(lv, consumer.view(lv.shape), S)],
                             dim=-1).long()
            hit = torch.zeros((lv.shape[0], S + 1), dtype=torch.bool,
                              device=lv.device).scatter_(1, ends, True)
            self._solve.append((lv.shape[-1], lv.sum(-1),
                                hit[:, :S].sum(-1)))
            return solve0(provider, consumer, p_l, live, perf, **kw)

        def masked_min(cand, mask):
            lanes = cand.shape[0] if cand.dim() > 1 else 1
            self._min.append(dict(n_lanes=lanes, n=cand.shape[-1]))
            return min0(cand, mask)

        # the kernel's wrapper counts its launches on its own module-level
        # name, which now names this recorder
        solve.launches = solve0.launches
        maxmin.maxmin_solve, advance.masked_min = solve, masked_min
        return self

    def __exit__(self, *exc):
        from repro_torch.core.loop import advance
        from repro_torch.kernels import maxmin
        self._solve0.launches = maxmin.maxmin_solve.launches
        maxmin.maxmin_solve, advance.masked_min = self._solve0, self._min0
        return False

    def counters(self) -> dict:
        solve = []
        if self._solve:
            live = torch.stack([a for _, a, _ in self._solve]).tolist()
            touched = torch.stack([b for _, _, b in self._solve]).tolist()
            solve = [dict(n_flows=c, n_live=a, n_touched=b) for (c, _, _), a, b
                     in zip(self._solve, live, touched)]
        return dict(maxmin_solve=solve, masked_min=list(self._min))
