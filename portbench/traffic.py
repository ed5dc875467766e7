"""The general traffic generator: from a configuration (the deployment and
its trace family) and a traffic mix (lanes, grid, policies, traces a call)
to the lanes of one sweep call and their traces.

Everything a lane needs is plain data here (floats rounded to float32, as
the engine holds them, policy names, NumPy trace arrays), so the engine
and the reference receive the same inputs.  A call's traces depend only on
``(seed, call index, trace index)``; the same seed gives the same calls.
"""
from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np

# the engine's float parameters of a lane (CloudParams fields)
FLOAT_FIELDS = ("pm_cores", "perf_core", "net_bw", "repo_bw", "image_mb",
                "boot_work", "vm_mem_mb", "latency_s", "metering_period",
                "consolidate_idle_frac")


def f32(x: float) -> float:
    """``x`` as the float32 the engine holds, widened back to a float."""
    return float(np.float32(x))


class Lane(NamedTuple):
    trace: int      # which of the call's traces
    point: dict     # the lane's parameters and policy names


def lanes(config: dict, mix: dict) -> list[Lane]:
    """The lanes of one call, trace-major: every trace under every policy
    pair (the configuration's own when the mix names none) under every
    grid point."""
    base = config["cloud"]
    grid = mix.get("grid") or {}
    names = list(grid)
    points = [dict(zip(names, combo))
              for combo in itertools.product(*(grid[n] for n in names))]
    pairs = mix.get("policies") or [[base["vm_sched"], base["pm_sched"]]]
    out = []
    for k in range(int(mix["traces_per_call"])):
        for vm, pm in pairs:
            for p in points:
                point = {f: f32(p.get(f, base[f])) for f in FLOAT_FIELDS}
                point.update(vm_sched=vm, pm_sched=pm)
                out.append(Lane(k, point))
    return out


def rng_for(seed: int, call: int, trace: int) -> np.random.RandomState:
    """The generator of one trace: any whole-number seed (more than 32
    bits is fine), the call's index (negative for set-up and the profiled
    slice) and the trace's index in the call."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, call % 2 ** 32, trace])
    return np.random.RandomState(np.random.MT19937(ss))


def gwa_trace(workload: dict, n_tasks: int,
              rng: np.random.RandomState) -> dict:
    """A trace matched to a Grid Workloads Archive family's published
    marginals: Weibull inter-arrival gaps, log-normal runtimes (capped),
    power-of-two core counts; a task's work is its runtime times its
    cores.  float32 arrays, as the engine takes them."""
    w = workload
    gaps = w["interarrival_scale"] * rng.weibull(w["interarrival_shape"],
                                                 n_tasks)
    arrival = np.cumsum(gaps).astype(np.float32)
    runtime = np.exp(rng.normal(w["runtime_logmean"], w["runtime_logstd"],
                                n_tasks))
    runtime = np.minimum(runtime, w["runtime_cap_s"]).astype(np.float32)
    probs = np.asarray(w["par_probs"], np.float64)
    pow2 = rng.choice(len(probs), size=n_tasks, p=probs / probs.sum())
    cores = np.minimum((2.0 ** pow2).astype(np.float32),
                       np.float32(w["max_cores"]))
    return dict(arrival=arrival, cores=cores,
                work=(runtime * cores).astype(np.float32))


def call_traces(config: dict, mix: dict, seed: int, call: int) -> list[dict]:
    """The traces of one call: ``mix["n_tasks"]`` tasks each where the mix
    sets it, else the configuration's."""
    n = int(mix.get("n_tasks") or config["n_tasks"])
    return [gwa_trace(config["workload"], n, rng_for(seed, call, k))
            for k in range(int(mix["traces_per_call"]))]
