"""Workload traces (paper §4.2): synthetic generator + GWA-like families.

Port of ``repro.core.trace``: the same numpy generators, seeded the same way,
so every array is bit-equal to the reference's.  The traces hold numpy
arrays; :func:`repro_torch.core.engine.simulate` moves them to the device.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from .engine import Trace


def synthetic_trace(n_tasks: int, parallel: int, spread_s: float = 10.0,
                    length_range: tuple[float, float] = (10.0, 90.0),
                    cores: int = 1, perf_core: float = 1.0,
                    seed: int = 0) -> Trace:
    """Paper Fig. 11 synthetic load: batches of ``parallel`` tasks whose
    starts fall within ``spread_s``, lengths uniform in ``length_range``."""
    rng = np.random.RandomState(seed)
    lo, hi = length_range
    length = rng.uniform(lo, hi, n_tasks).astype(np.float32)
    offs = rng.uniform(0.0, spread_s, n_tasks).astype(np.float32)
    batch = np.arange(n_tasks) // max(parallel, 1)
    gap = hi + spread_s   # long enough for all earlier tasks to finish
    arrival = batch.astype(np.float32) * gap + offs
    return Trace(
        arrival=np.asarray(arrival, np.float32),
        cores=np.full((n_tasks,), float(cores), np.float32),
        work=np.asarray(length * cores * perf_core, np.float32),
    )


@dataclasses.dataclass(frozen=True)
class GWAFamily:
    """Moment parameters for one archive system (published marginals)."""

    name: str
    runtime_logmean: float
    runtime_logstd: float
    interarrival_scale: float
    interarrival_shape: float
    par_probs: tuple[float, ...]
    max_cores: int = 64


GWA_FAMILIES: dict[str, GWAFamily] = {
    "das2":      GWAFamily("das2", 4.1, 1.9, 35.0, 0.55, (0.35, 0.2, 0.2, 0.15, 0.07, 0.03)),
    "grid5000":  GWAFamily("grid5000", 5.3, 2.2, 50.0, 0.50, (0.5, 0.15, 0.12, 0.1, 0.08, 0.05)),
    "nordugrid": GWAFamily("nordugrid", 7.2, 1.8, 120.0, 0.60, (0.9, 0.06, 0.03, 0.01)),
    "auvergrid": GWAFamily("auvergrid", 6.8, 1.7, 90.0, 0.65, (0.97, 0.02, 0.01)),
    "sharcnet":  GWAFamily("sharcnet", 6.9, 2.4, 25.0, 0.45, (0.55, 0.15, 0.12, 0.1, 0.05, 0.03)),
    "lcg":       GWAFamily("lcg", 5.9, 1.6, 8.0, 0.70, (1.0,)),
}


def gwa_like_trace(family: str, n_tasks: int, *, perf_core: float = 1.0,
                   max_cores: int | None = None,
                   runtime_cap_s: float = 3.0e5, seed: int = 0) -> Trace:
    """A GWA-moment-matched trace for ``family`` (see GWA_FAMILIES)."""
    fam = GWA_FAMILIES[family]
    # stable per-family seed: crc32, identical in every process
    rng = np.random.RandomState(
        seed ^ zlib.crc32(family.encode()) & 0x7FFFFFFF)
    inter = fam.interarrival_scale * rng.weibull(fam.interarrival_shape,
                                                 n_tasks)
    arrival = np.cumsum(inter).astype(np.float32)
    runtime = np.exp(rng.normal(fam.runtime_logmean, fam.runtime_logstd,
                                n_tasks))
    runtime = np.minimum(runtime, runtime_cap_s).astype(np.float32)
    probs = np.asarray(fam.par_probs, np.float64)
    probs = probs / probs.sum()
    pow2 = rng.choice(len(probs), size=n_tasks, p=probs)
    cores = (2.0 ** pow2).astype(np.float32)
    cap = float(max_cores if max_cores is not None else fam.max_cores)
    cores = np.minimum(cores, cap)
    return Trace(arrival=arrival, cores=cores,
                 work=np.asarray(runtime * cores * perf_core, np.float32))


def filter_fitting(trace: Trace, pm_cores: float) -> Trace:
    """Drop tasks larger than one PM (paper §4.2.2 scalability protocol)."""
    cores = np.asarray(trace.cores)
    keep = cores <= pm_cores
    return Trace(arrival=np.asarray(trace.arrival)[keep], cores=cores[keep],
                 work=np.asarray(trace.work)[keep])
