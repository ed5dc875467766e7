"""Streamed workload windows (port of ``repro.data.pipeline``, its
:func:`gwa_window_stream`; the LM batches of that module wait for ROADMAP
item 14.6).

The windows are drawn with numpy from the same counter-keyed Philox
streams as the reference's, so every window is bit-equal to its window.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from ..core.engine import Trace
from ..core.trace import GWA_FAMILIES


def gwa_window_stream(family: str, n_tasks: int, window: int, *,
                      perf_core: float = 1.0, max_cores: int | None = None,
                      runtime_cap_s: float = 3.0e5, seed: int = 0):
    """Generator of GWA-moment-matched trace windows.

    The streaming counterpart of :func:`repro_torch.core.trace.
    gwa_like_trace`: yields fixed-shape ``[window]`` gid-carrying
    :class:`~repro_torch.core.engine.Trace` windows (CPU tensors) one at
    a time, so the full ``n_tasks`` trace is never held and a long
    workload streams through :func:`repro_torch.core.engine.
    simulate_stream` in O(window) host memory.  Window ``k``'s draws come
    from a Philox stream keyed on ``(seed, family, k)``; only the arrival
    offset (a float64 scalar) carries across windows, so arrivals are
    sorted across the stream.  The last window is padded and masked
    (``gid == -1``)."""
    fam = GWA_FAMILIES[family]
    cap_cores = float(max_cores if max_cores is not None else fam.max_cores)
    probs = np.asarray(fam.par_probs, np.float64)
    probs = probs / probs.sum()
    fam_key = zlib.crc32(family.encode()) & 0xFFFFFFFF
    W = int(window)
    if W <= 0:
        raise ValueError(f"window must be positive, got {window}")
    offset = 0.0  # float64 running arrival time, carried across windows
    for k, start in enumerate(range(0, n_tasks, W)):
        n = min(W, n_tasks - start)
        key = (seed & 0xFFFFFFFF) << 64 | fam_key << 32 | (k & 0xFFFFFFFF)
        rng = np.random.Generator(np.random.Philox(key=key))
        inter = fam.interarrival_scale * rng.weibull(
            fam.interarrival_shape, n)
        arrival = offset + np.cumsum(inter)
        offset = float(arrival[-1])
        runtime = np.minimum(
            np.exp(rng.normal(fam.runtime_logmean, fam.runtime_logstd, n)),
            runtime_cap_s)
        cores = np.minimum(
            2.0 ** rng.choice(len(probs), size=n, p=probs), cap_cores)
        pad = W - n

        def padded(x, fill, dtype):
            x = np.asarray(x, dtype)
            if pad:
                x = np.concatenate([x, np.full((pad,), fill, dtype)])
            return torch.from_numpy(x)

        yield Trace(
            arrival=padded(arrival, np.inf, np.float32),
            cores=padded(cores, 0.0, np.float32),
            work=padded(runtime * cores * perf_core, 0.0, np.float32),
            gid=padded(np.arange(start, start + n), -1, np.int32),
        )
