"""Split a batched sweep's lanes over devices (port of
``repro.experiments.shard``).

A stacked sweep (:func:`repro_torch.core.engine.stack_params` /
``stack_traces``, or :func:`repro_torch.experiments.pareto.param_grid`)
is one batch whose lanes never communicate.  The reference splits that
axis over a device mesh with ``shard_map``; here ``devices`` is a list of
torch devices and each shard runs the batched engine on its own device,
from the host, one after another.

* ``min(batch size, device count)`` shards.  A batch that does not divide
  evenly is padded with copies of its leading rows up to the next
  multiple of the shard count, and the pad lanes are dropped from the
  result.  One device (or one point) runs plain
  :func:`~repro_torch.core.engine.simulate_batch`.
* Each lane is bit-equal to the unsplit call: the engine computes every
  lane as that lane alone would be computed, so splitting the batch, or
  appending pad lanes that are later dropped, changes where a lane runs,
  never its arithmetic.
* ``devices=None`` means every visible CUDA card (one on a one-card
  machine); with no card it raises, as the engine's entry points do.
  The CPU tests pass ``devices=["cpu", "cpu"]``.

Every experiment kind of this package (:mod:`~repro_torch.experiments.
pareto`, :mod:`~repro_torch.experiments.ensemble`,
:mod:`~repro_torch.experiments.tournament`) runs its batch through
:func:`run_batch`.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core import engine
from ..core.energy import MeterParams, PowerStateTable
from ..device import resolve_device


def _params_leaves(params: engine.CloudParams):
    """``(field, sub-field, value, dims of one scenario)`` of every leaf of
    ``params``, in the reference's leaf order."""
    for f in dataclasses.fields(engine.CloudParams):
        value = getattr(params, f.name)
        if f.name == "power":
            for k in PowerStateTable._fields:
                yield f.name, k, getattr(value, k), 1
        elif f.name == "meter":
            for k in ("indirect_base", "indirect_coeff"):
                yield f.name, k, getattr(value, k), 1
        else:
            yield f.name, None, value, 0


def _leaves(trace, params):
    """Every leaf of ``(trace, params)`` with its "carries a batch axis"
    flag, in the order of ``jax.tree.leaves((trace, params))`` in the
    reference (``trace`` may be None: a stream's params alone)."""
    out = []
    if trace is not None:
        out += [(x, engine._ndim(x) > 1) for x in trace if x is not None]
    out += [(x, engine._ndim(x) > dims)
            for _, _, x, dims in _params_leaves(params)]
    return out


def _rebuild(trace, params, values):
    """``(trace, params)`` with their leaves replaced by ``values`` (in
    :func:`_leaves` order)."""
    values = iter(values)
    if trace is not None:
        trace = engine.Trace(*(None if x is None else next(values)
                               for x in trace))
    kw, power, meter = {}, {}, {}
    for name, sub, _, _ in _params_leaves(params):
        v = next(values)
        {"power": power, "meter": meter}.get(name, kw)[sub or name] = v
    params = dataclasses.replace(params, **kw, power=PowerStateTable(**power),
                                 meter=MeterParams(**meter))
    return trace, params


def batch_flags(spec: engine.CloudSpec, trace: engine.Trace,
                params: engine.CloudParams) -> tuple[bool, ...]:
    """Per-leaf "carries a leading batch axis" flags, aligned with the
    reference's ``jax.tree.leaves((trace, params))``, by the engine's own
    rule (a leaf with one more axis than one scenario's)."""
    return tuple(f for _, f in _leaves(trace, params))


def batch_size(spec: engine.CloudSpec, trace: engine.Trace,
               params: engine.CloudParams) -> int:
    """Length of the sweep's leading batch axis (every batched leaf must
    agree)."""
    sizes = {int(engine._as_tensor(x).shape[0])
             for x, f in _leaves(trace, params) if f}
    if not sizes:
        raise ValueError(
            "no batched leaf (leading batch axis) in `trace` or `params`; "
            "stack points with stack_params/stack_traces first")
    if len(sizes) > 1:
        raise ValueError(
            f"inconsistent batch-axis lengths across leaves: {sorted(sizes)}")
    return sizes.pop()


def shard_count(n_points: int, n_devices: int | None = None) -> int:
    """Number of shards :func:`simulate_batch_sharded` uses: ``min(n_points,
    n_devices)`` (default: the visible CUDA cards); batch sizes that do
    not divide evenly are padded (:func:`pad_rows`) rather than dropping
    to fewer devices."""
    if n_devices is None:
        n_devices = torch.cuda.device_count()
    return max(min(n_points, n_devices), 1)


def pad_rows(n_points: int, n_shards: int) -> int:
    """How many pad lanes :func:`simulate_batch_sharded` appends so the
    batch divides over ``n_shards`` (0 when it already divides)."""
    return -n_points % max(n_shards, 1)


def _pad_batch(trace_params, flags, pad: int):
    """Append ``pad`` copies of the leading rows to every batched leaf."""
    trace, params = trace_params
    values = [torch.cat([engine._as_tensor(x), engine._as_tensor(x)[:pad]])
              if f else x
              for (x, _), f in zip(_leaves(trace, params), flags)]
    return _rebuild(trace, params, values)


def _shard(trace_params, flags, lanes: slice):
    """The lanes ``lanes`` of every batched leaf (views)."""
    trace, params = trace_params
    values = [engine._as_tensor(x)[lanes] if f else x
              for (x, _), f in zip(_leaves(trace, params), flags)]
    return _rebuild(trace, params, values)


def _devices(devices) -> list[torch.device]:
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            return [resolve_device(None)]    # raises: no card
        return [torch.device("cuda", i) for i in range(n)]
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("devices must name at least one device")
    return devices


def _gather(parts, n: int, device):
    """The shards' results as one batch on ``device``, the pad lanes
    dropped."""
    first = parts[0]
    if torch.is_tensor(first):
        return torch.cat([p.to(device) for p in parts])[:n]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_gather(list(xs), n, device)
                             for xs in zip(*parts)))
    return first


def _split(n: int, devs: list) -> tuple[int, int]:
    """(shards, lanes a shard) for ``n`` lanes over ``devs``."""
    d = shard_count(n, len(devs))
    return d, (n + pad_rows(n, d)) // d


def simulate_batch_sharded(
        spec: engine.CloudSpec, trace: engine.Trace,
        params: engine.CloudParams, t_stop: float = math.inf,
        devices=None) -> engine.CloudResult:
    """:func:`repro_torch.core.engine.simulate_batch`, the lanes split over
    ``devices``.

    Batch sizes that do not divide the shard count are padded with copies
    of the leading rows and the pad lanes dropped from the result.  One
    shard (one device, or one point) is plain ``simulate_batch`` on that
    device.  Each lane is bit-equal either way; the result lies on the
    first device."""
    devs = _devices(devices)
    n = batch_size(spec, trace, params)
    d, m = _split(n, devs)
    if d <= 1:
        return engine.simulate_batch(spec, trace, params, t_stop,
                                     device=devs[0])
    flags = batch_flags(spec, trace, params)
    padded = _pad_batch((trace, params), flags, d * m - n)
    parts = [engine.simulate_batch(spec, *_shard(padded, flags,
                                                 slice(i * m, (i + 1) * m)),
                                   t_stop, device=devs[i])
             for i in range(d)]
    return _gather(parts, n, devs[0])


def simulate_stream_batch(
        spec: engine.CloudSpec, windows, params: engine.CloudParams, *,
        n_slots: int | None = None, t_stop: float = math.inf,
        devices=None) -> engine.StreamResult:
    """:func:`repro_torch.core.engine.simulate_stream` over a batched
    parameter sweep (``stack_params`` / ``param_grid``): every lane
    replays the same windows under its own parameter and scheduler point,
    all lanes in the same passes (each kernel launch serves every lane of
    a shard), split over ``devices`` as :func:`simulate_batch_sharded`
    splits a batch.  Each lane is bit-equal to its own ``simulate_stream``.

    Returns a :class:`~repro_torch.core.engine.StreamResult` whose every
    leaf leads with the batch."""
    devs = _devices(devices)
    engine._check_meter_params(spec, params)
    flags = batch_flags(spec, None, params)
    if not any(flags):
        raise ValueError(
            "simulate_stream_batch needs at least one batched params leaf "
            "(leading batch axis); use simulate_stream for a single point")
    sizes = {int(engine._as_tensor(x).shape[0])
             for x, f in _leaves(None, params) if f}
    if len(sizes) > 1:
        raise ValueError(
            f"inconsistent batch-axis lengths across leaves: {sorted(sizes)}")
    n = sizes.pop()
    d, m = _split(n, devs)
    _, padded = _pad_batch((None, params), flags, d * m - n)
    shards = [(engine.lane_params(_shard((None, padded), flags,
                                         slice(i * m, (i + 1) * m))[1],
                                  m, devs[i]), devs[i])
              for i in range(d)]
    parts = engine._run_stream(spec, windows, shards, n_slots, t_stop)
    return parts[0] if d == 1 else _gather(parts, n, devs[0])


def run_batch(spec: engine.CloudSpec, trace: engine.Trace,
              params: engine.CloudParams, *, t_stop: float = math.inf,
              sharded: bool = True, devices=None) -> engine.CloudResult:
    """The experiment layer's one batch-execution path: split over
    ``devices`` by default, plain ``simulate_batch`` on the first of them
    on request."""
    if not sharded:
        return engine.simulate_batch(spec, trace, params, t_stop,
                                     device=_devices(devices)[0])
    return simulate_batch_sharded(spec, trace, params, t_stop, devices)
