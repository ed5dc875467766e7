"""The traced slice: one sweep call, bounded by a stop time, under
``torch.profiler``, reduced from the trace's raw events to what the
per-layer readers read (:class:`Slice`).

The raw events are walked once: the profiler's own per-event records
(``key_averages``) take minutes at a few hundred thousand launches, so they
are not built.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from collections import Counter

SPAN = "portbench.run_batch"   # the harness's span around each call


@dataclasses.dataclass
class Slice:
    """What the traced slice showed, and the counters read beside it."""

    wall_s: float                    # host clock over the slice, synchronised
    busy_s: float                    # union of device-busy intervals
    kernels: Counter                 # device kernel launches by name
    kernel_s: Counter                # device seconds by kernel name
    device_ops: list                 # [name, seconds] of the top device ops
    idle_gaps: list                  # [host op, idle seconds] of the top labels
    dtoh_reads: int                  # device-to-host copies
    lane_events: int = 0             # simulated events of all lanes

    @property
    def n_kernels(self) -> int:
        return sum(self.kernels.values())

    def kernel(self, name: str) -> tuple[int, float]:
        """(launches, device seconds) of the kernels whose function name
        is ``name``."""
        n = s = 0
        for full, k in self.kernels.items():
            if kernel_name(full) == name:
                n += k
                s += self.kernel_s[full]
        return n, s


def kernel_name(full: str) -> str:
    """A device kernel's function name from its demangled signature."""
    words = full.split("(")[0].split("<")[0].split()
    return words[-1] if words else full


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def profile_call(fn, sync) -> tuple[object, Slice]:
    """Run ``fn`` under the profiler (CPU and CUDA activity); ``sync``
    waits for the device.  Returns ``fn``'s result and the slice."""
    from torch.autograd import DeviceType
    from torch.autograd import profiler as autograd_profiler
    from torch.profiler import ProfilerActivity, profile

    sync()
    parse0 = autograd_profiler.profile._parse_kineto_results
    autograd_profiler.profile._parse_kineto_results = lambda self, res: []
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            sync()
            wall = time.perf_counter() - t0
    finally:
        autograd_profiler.profile._parse_kineto_results = parse0
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if e.device_type() != DeviceType.CUDA:
            host.append(rec)
        elif not e.is_user_annotation() and e.name() != SPAN:
            # the device-side copy of a host span is no device work
            device.append(rec)
    return out, reduce(device, host, wall)


def reduce(device, host, wall_s: float, top: int = 10) -> Slice:
    """A :class:`Slice` from raw ``(start_ns, end_ns, name)`` events."""
    kernels, kernel_s, op_s = Counter(), Counter(), Counter()
    dtoh = 0
    for a, b, name in device:
        op_s[name] += (b - a) / 1e9
        if _is_copy(name):
            dtoh += "DtoH" in name
        else:
            kernels[name] += 1
            kernel_s[name] += (b - a) / 1e9
    # the union of the busy intervals, and the gaps between them
    busy = 0.0
    gaps = []
    end = None
    for a, b, _ in sorted(device):
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += (b - a) / 1e9
            end = b
        elif b > end:
            busy += (b - end) / 1e9
            end = b
    # each gap under the innermost host op (not a CUDA runtime call) that
    # covers its middle
    ops = sorted((a, b, n) for a, b, n in host if not n.startswith("cuda"))
    starts = [a for a, _, _ in ops]
    idle = Counter()
    for g0, g1 in gaps:
        label = "python between ops"
        mid = (g0 + g1) / 2
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 64, -1), -1):
            if ops[j][1] >= mid:
                label = ops[j][2]
                break
        idle[label] += (g1 - g0) / 1e9
    return Slice(
        wall_s=wall_s, busy_s=busy, kernels=kernels, kernel_s=kernel_s,
        device_ops=[[n[:120], s] for n, s in op_s.most_common(top)],
        idle_gaps=[[n[:120], s] for n, s in idle.most_common(top)],
        dtoh_reads=dtoh)
