"""Workload traces (paper §4.2): synthetic generator + GWA-like families.

Port of ``repro.core.trace``: the same numpy generators, seeded the same way,
so every array is bit-equal to the reference's.  The traces hold numpy
arrays; :func:`repro_torch.core.engine.simulate` moves them to the device.
:func:`chunk_trace` cuts a trace into the fixed-shape windows of
:func:`repro_torch.core.engine.simulate_stream` (CPU tensors).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import NamedTuple

import numpy as np
import torch

from .engine import Trace, _host_array


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


class WindowedTrace(NamedTuple):
    """A trace chunked on the task axis: ``n_windows`` windows of one
    shape ``[W]``, the last one padded (``gid == -1`` marks a pad entry:
    ``arrival == inf``, zero cores and work).  CPU tensors;
    :func:`repro_torch.core.engine.simulate_stream` replays them with a
    task axis of a fixed slot pool, whatever the total length."""

    arrival: torch.Tensor  # f32[n_windows, W]
    cores: torch.Tensor    # f32[n_windows, W]
    work: torch.Tensor     # f32[n_windows, W]
    gid: torch.Tensor      # i32[n_windows, W]; -1 = pad

    @property
    def n_windows(self) -> int:
        return self.arrival.shape[0]

    @property
    def window_size(self) -> int:
        return self.arrival.shape[1]

    @property
    def n_tasks(self) -> int:
        """Number of real (non-pad) tasks across all windows."""
        return int((self.gid >= 0).sum())

    def window(self, k: int) -> Trace:
        """Window ``k`` as a gid-carrying :class:`Trace`."""
        return Trace(arrival=self.arrival[k], cores=self.cores[k],
                     work=self.work[k], gid=self.gid[k])

    def windows(self):
        """The windows in stream order (``__iter__`` stays the NamedTuple's
        iteration over its fields)."""
        for k in range(self.n_windows):
            yield self.window(k)


def chunk_trace(trace: Trace, window: int) -> WindowedTrace:
    """Chunk a :class:`Trace` into fixed-shape windows for
    :func:`repro_torch.core.engine.simulate_stream`, on the host.

    The last window is padded up to ``window`` tasks and masked (``gid ==
    -1``, ``arrival == inf``); global ids are the original task indices
    (or the trace's own ``gid``), so a streamed replay's per-task outputs
    align with the monolithic trace axis.  An unsorted trace is first
    sorted by arrival, stably (ties keep their relative order): the
    streaming sentinel, the next window's first arrival, is the true
    horizon minimum only when arrivals never go back in time."""
    W = int(window)
    if W <= 0:
        raise ValueError(f"window must be positive, got {window}")
    arrival = _host_array(trace.arrival, np.float32)
    T = arrival.shape[0]
    if T == 0:
        raise ValueError("chunk_trace needs a non-empty trace")
    gid = (_host_array(trace.gid, np.int32) if trace.gid is not None
           else np.arange(T, dtype=np.int32))
    cores = _host_array(trace.cores, np.float32)
    work = _host_array(trace.work, np.float32)
    if np.any(np.diff(arrival) < 0):
        order = np.argsort(arrival, kind="stable")
        arrival, cores, work, gid = (arrival[order], cores[order],
                                     work[order], gid[order])
    n_windows = -(-T // W)
    pad = n_windows * W - T

    def chunk(x, fill):
        x = np.concatenate([x, np.full((pad,), fill, x.dtype)])
        return torch.from_numpy(x.reshape(n_windows, W))

    return WindowedTrace(arrival=chunk(arrival, np.inf),
                         cores=chunk(cores, 0.0), work=chunk(work, 0.0),
                         gid=chunk(gid, -1))


def filter_fitting(trace: Trace, pm_cores: float) -> Trace:
    """Drop tasks larger than one PM (paper §4.2.2 scalability protocol)."""
    cores = np.asarray(trace.cores)
    keep = cores <= pm_cores
    return Trace(arrival=np.asarray(trace.arrival)[keep], cores=cores[keep],
                 work=np.asarray(trace.work)[keep])
