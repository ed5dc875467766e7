"""Streaming trace windows: the port's ``chunk_trace``, ``gwa_window_stream``,
``simulate_stream`` and ``simulate_stream_batch`` against live JAX runs of the
reference on the same inputs, and against the port's own monolithic
``simulate``.

Against JAX (the inputs flattened to numpy and fed to the port): windows
bit for bit; for a run, ``n_events`` and every integer, bool and state leaf
exactly, floats (``window_energy`` included) rtol 1e-5 / atol 1e-6, the
Kahan low words (``*.energy_lo``, ``t_c``) never compared.  Against the
port's own monolithic run: every leaf of the result that both carry, bit
for bit.  Each JAX run is made once per module.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import math
import pathlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import energy as jenergy
from repro.core import engine as jeng
from repro.core import trace as jtrace
from repro.data import pipeline as jpipe
from repro.experiments import shard as jshard
from repro_torch.core import energy as tenergy
from repro_torch.core import engine as teng
from repro_torch.core import trace as ttrace
from repro_torch.data import pipeline as tpipe
from repro_torch.experiments import shard as tshard
from repro_torch.sched import registry
from test_torch_engine import ATOL, RTOL, UNCOMPARED, jflat

ROOT = pathlib.Path(__file__).resolve().parent.parent
SPEC_FIELDS = {f.name for f in dataclasses.fields(teng.CloudSpec)}


def _bits(x) -> bytes:
    return np.asarray(x).tobytes()


def _port_spec(kw):
    return teng.CloudSpec(**{k: v for k, v in kw.items() if k in SPEC_FIELDS})


def _flat(res, spec) -> dict:
    out = teng.to_numpy(res)
    out.update({f"readings.{k}": v.numpy()
                for k, v in res.readings(spec).items()})
    return out


def _jflat(res, spec) -> dict:
    out = jflat(res)
    out.update({f"readings.{k}": np.asarray(v)
                for k, v in res.readings(spec).items()})
    return out


def _assert_matches_jax(got: dict, want: dict):
    assert set(got) == set(want), set(got) ^ set(want)
    np.testing.assert_array_equal(got["n_events"], want["n_events"])
    for k in sorted(want):
        w, g = want[k], got[k]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if k.endswith(UNCOMPARED):
            continue
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64), err_msg=k)


def _assert_stream_equals_mono(stream: dict, mono: dict):
    """Every leaf the monolithic result carries, bit for bit, but the
    per-task state, whose axis is the slot pool in a stream."""
    keys = [k for k in mono
            if not k.startswith(("state.task_", "state.t_done",
                                 "state.vm_task"))]
    assert keys and set(keys) <= set(stream)
    bad = [k for k in keys if _bits(stream[k]) != _bits(mono[k])]
    assert not bad, bad


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------

def _ramp(n: int, jax: bool = False):
    arrays = (np.arange(n, dtype=np.float32), np.ones(n, np.float32),
              np.full(n, 5.0, np.float32))
    if jax:
        return jeng.Trace(*(jnp.asarray(x) for x in arrays))
    return teng.Trace(*arrays)


UNSORTED = (np.array([2.0, 0.0, 1.0, 1.0], np.float32),
            np.array([1.0, 2.0, 4.0, 8.0], np.float32),
            np.array([10.0, 20.0, 40.0, 80.0], np.float32))


@pytest.mark.parametrize("case", ["sorted", "unsorted", "padded", "gid"])
def test_chunk_trace_matches_reference(case):
    """Sorted, unsorted (stable order, original ids as ``gid``), a padded
    last window, and a trace carrying its own ``gid``: every field bit for
    bit, and the derived counts."""
    if case == "unsorted":
        arrays, W = UNSORTED, 2
    elif case == "gid":
        arrays, W = UNSORTED + (np.array([7, 5, 3, 1], np.int32),), 3
    else:
        arrays, W = tuple(_ramp(10)), (5 if case == "sorted" else 4)
    want = jtrace.chunk_trace(jeng.Trace(*(jnp.asarray(x) for x in arrays
                                           if x is not None)), W)
    got = ttrace.chunk_trace(teng.Trace(*arrays), W)
    assert isinstance(got.arrival, torch.Tensor)
    assert got.arrival.device.type == "cpu" and got.gid.dtype == torch.int32
    for k in ("arrival", "cores", "work", "gid"):
        assert _bits(getattr(got, k)) == _bits(getattr(want, k)), k
    assert ((got.n_windows, got.window_size, got.n_tasks)
            == (want.n_windows, want.window_size, want.n_tasks))
    for a, b in zip(got.windows(), want.windows()):
        assert all(_bits(x) == _bits(y) for x, y in zip(a, b))


def test_chunk_trace_errors_match_reference():
    for fn, mk in ((jtrace.chunk_trace, lambda n: _ramp(n, jax=True)),
                   (ttrace.chunk_trace, _ramp)):
        with pytest.raises(ValueError, match="window must be positive"):
            fn(mk(4), 0)
        with pytest.raises(ValueError, match="window must be positive"):
            fn(mk(4), -3)
        with pytest.raises(ValueError, match="non-empty"):
            fn(mk(0), 4)


def test_stack_traces_gid_rules():
    with_gid = _ramp(4)._replace(gid=np.arange(4, dtype=np.int32))
    with pytest.raises(ValueError, match="mix"):
        teng.stack_traces([_ramp(4), with_gid])
    plain = teng.stack_traces([_ramp(4), _ramp(4)])
    assert plain.gid is None and plain.arrival.shape == (2, 4)
    both = teng.stack_traces([with_gid, with_gid])
    assert both.gid.dtype == torch.int32 and both.gid.shape == (2, 4)
    moved = with_gid.to("cpu")
    assert moved.gid.dtype == torch.int32 and moved.arrival.dtype == \
        torch.float32
    assert _ramp(4).to("cpu").gid is None


@pytest.mark.parametrize("kw", [dict(), dict(max_cores=4, seed=5)])
def test_gwa_window_stream_matches_reference(kw):
    want = list(jpipe.gwa_window_stream("das2", 70, 16, **kw))
    got = list(tpipe.gwa_window_stream("das2", 70, 16, **kw))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        for k in ("arrival", "cores", "work", "gid"):
            assert _bits(getattr(a, k)) == _bits(getattr(b, k)), k
    with pytest.raises(ValueError, match="window must be positive"):
        next(tpipe.gwa_window_stream("das2", 10, 0))


# ---------------------------------------------------------------------------
# goldens streaming_windows / streaming_compact against live JAX
# ---------------------------------------------------------------------------

def _golden_streams():
    spec_ = importlib.util.spec_from_file_location(
        "make_golden", ROOT / "tools/make_golden.py")
    mg = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mg)
    return dict(mg.scenarios())


GOLDEN = {
    # tools/make_golden.py: the golden trace sorted, W = ceil(T / 4)
    "streaming_windows": dict(n_pm=3, n_vm=12, pm_cores=4.0,
                              vm_sched="smallestfirst", pm_sched="ondemand",
                              metering_period=0.25),
    # the sparse trace, bucket 8, W = ceil(T / 4)
    "streaming_compact": dict(n_pm=3, n_vm=12, pm_cores=4.0,
                              vm_sched="firstfit", pm_sched="ondemand",
                              metering_period=0.25, compact=8),
}


def _golden_windows(name):
    if name == "streaming_windows":
        tr = jtrace.synthetic_trace(16, 4, spread_s=40.0,
                                    length_range=(5.0, 60.0), seed=11)
        order = np.argsort(np.asarray(tr.arrival), kind="stable")
        tr = jeng.Trace(arrival=tr.arrival[order], cores=tr.cores[order],
                        work=tr.work[order])
    else:
        tr = jtrace.synthetic_trace(20, 4, spread_s=250.0,
                                    length_range=(5.0, 40.0), seed=23)
    return jtrace.chunk_trace(tr, -(-tr.n // 4))


@pytest.fixture(scope="module")
def golden_runs():
    """Both goldens on the port and on JAX, each run once."""
    scenarios = _golden_streams()
    out = {}
    for name, kw in GOLDEN.items():
        jspec, jres = scenarios[name]()
        port_wt = ttrace.WindowedTrace(
            *(torch.from_numpy(np.array(x)) for x in _golden_windows(name)))
        params = teng.params_from_numpy(jflat(jeng.make_cloud(**kw)[1]))
        spec = _port_spec(kw)
        res = teng.simulate_stream(spec, port_wt, params, device="cpu")
        out[name] = (spec, _jflat(jres, jspec), res)
    return out


@pytest.mark.parametrize("name", list(GOLDEN))
def test_simulate_stream_matches_live_jax(name, golden_runs):
    spec, want, res = golden_runs[name]
    assert want["window_t_end"].shape == (4,)
    _assert_matches_jax(_flat(res, spec), want)


# ---------------------------------------------------------------------------
# the port's stream against the port's monolithic run
# ---------------------------------------------------------------------------

GRID = [(vm, pm) for vm in registry.names("vm") for pm in registry.names("pm")]


@pytest.fixture(scope="module")
def grid_runs():
    """tests/test_streaming.py's grid scenario (4 PM x 16 VM, das2 40 tasks
    under 8 cores, metering every 25 s) with every VM x PM pair as a lane:
    the monolithic batch and the stream batch at W = T / 4.  A lane of
    either batch is bit-equal to its single run (the batch tests), so the
    lanes hold all 15 pairs of the reference's grid at W = T / 4."""
    spec, base = teng.make_cloud(n_pm=4, n_vm=16, pm_cores=8.0,
                                 metering_period=25.0)
    trace = ttrace.filter_fitting(ttrace.gwa_like_trace("das2", 40, seed=3),
                                  8.0)
    params = teng.stack_params([dataclasses.replace(base, vm_sched=v,
                                                    pm_sched=p)
                                for v, p in GRID])
    mono = _flat(teng.simulate_batch(spec, trace, params, device="cpu"), spec)
    stream = _flat(tshard.simulate_stream_batch(
        spec, ttrace.chunk_trace(trace, trace.n // 4), params,
        devices=["cpu"]), spec)
    return spec, base, trace, mono, stream


def test_stream_matches_monolithic_on_the_grid(grid_runs):
    """Every VM x PM pair at W = T / 4, as the lanes of one batch."""
    _, _, _, mono, stream = grid_runs
    assert (mono["n_events"] > 10).all()
    for i, pair in enumerate(GRID):
        lane = {k: v[i] for k, v in stream.items()}
        try:
            _assert_stream_equals_mono(lane, {k: v[i]
                                              for k, v in mono.items()})
        except AssertionError as e:
            raise AssertionError(f"{pair}: {e}") from None


@pytest.mark.parametrize("pair", [("smallestfirst", "ondemand"),
                                  ("nonqueuing", "consolidate")])
def test_single_stream_matches_single_run(grid_runs, pair):
    """Two pairs of the grid as single runs, ``simulate_stream`` in one
    window (W = T) against ``simulate``.  Left out at W = T, for the
    time: the other 13 pairs (every pair runs at W = T / 4 above)."""
    spec, base, trace, _, _ = grid_runs
    params = dataclasses.replace(base, vm_sched=pair[0], pm_sched=pair[1])
    mono = _flat(teng.simulate(spec, trace, params, device="cpu"), spec)
    stream = _flat(teng.simulate_stream(
        spec, ttrace.chunk_trace(trace, trace.n), params, device="cpu"), spec)
    _assert_stream_equals_mono(stream, mono)


def test_smallestfirst_breaks_ties_on_global_id():
    """Equal core counts queued across a window boundary: a rejected task
    frees slot 0 at the end of window 0, window 1's first task takes it,
    and both it and an earlier task of the same size wait behind a
    blocker.  The monolithic engine serves the earlier task first (the
    lower index); a stream that broke the tie on the slot index would
    serve the later one, and their completions would differ."""
    spec, params = teng.make_cloud(n_pm=1, n_vm=4, pm_cores=4.0,
                                   vm_sched="smallestfirst",
                                   pm_sched="alwayson")
    trace = teng.Trace(
        arrival=np.array([0.0, 0.0, 1.0, 2.0, 3.0, 4.0], np.float32),
        cores=np.array([8.0, 4.0, 4.0, 4.0, 4.0, 4.0], np.float32),
        work=np.array([1.0, 400.0, 8.0, 40.0, 12.0, 20.0], np.float32))
    mono = teng.simulate(spec, trace, params, device="cpu")
    wt = ttrace.chunk_trace(trace, 3)
    assert wt.window(1).gid.tolist() == [3, 4, 5]
    stream = teng.simulate_stream(spec, wt, params, device="cpu")
    assert bool(mono.rejected[0]) and not bool(mono.rejected[1:].any())
    # the tie: task 2 (window 0) runs before task 3 (window 1, slot 0)
    assert float(mono.completion[2]) < float(mono.completion[3])
    assert _bits(stream.completion) == _bits(mono.completion)
    assert int(stream.n_events) == int(mono.n_events)


# ---------------------------------------------------------------------------
# the stream batch against JAX's simulate_stream_batch
# ---------------------------------------------------------------------------

def _sweep_points(base, n):
    names_vm, names_pm = registry.names("vm"), registry.names("pm")
    return [dataclasses.replace(
        base, net_bw=60.0 + 20.0 * i,
        vm_sched=names_vm[i % len(names_vm)],
        pm_sched=names_pm[i % len(names_pm)]) for i in range(n)]


STREAM_BATCH_CLOUD = dict(n_pm=2, n_vm=8, pm_cores=4.0)


def _jax_stream_batch():
    """tests/test_streaming.py's batched sweep on JAX: 2 PM x 8 VM, a
    10-task ramp in windows of 5, three points over the VM and PM codes
    and ``net_bw``."""
    jspec, jbase = jeng.make_cloud(**STREAM_BATCH_CLOUD)
    jpts = [dataclasses.replace(jbase, net_bw=jnp.float32(60.0 + 20.0 * i),
                                vm_sched=i % 3, pm_sched=i % 5)
            for i in range(3)]
    jres = jshard.simulate_stream_batch(
        jspec, jtrace.chunk_trace(_ramp(10, jax=True), 5),
        jeng.stack_params(jpts))
    return _jflat(jres, jspec)


def test_stream_batch_matches_jax_and_its_single_streams():
    """tests/test_streaming.py's batched sweep (:func:`_jax_stream_batch`)
    against JAX, each lane against its own ``simulate_stream``."""
    spec, base = teng.make_cloud(**STREAM_BATCH_CLOUD)
    pts = _sweep_points(base, 3)
    wt = ttrace.chunk_trace(_ramp(10), 5)
    res = tshard.simulate_stream_batch(spec, wt, teng.stack_params(pts),
                                       devices=["cpu"])
    got = _flat(res, spec)
    _assert_matches_jax(got, _jax_stream_batch())
    assert got["completion"].shape == (3, 10)
    for i, p in enumerate(pts):
        one = _flat(teng.simulate_stream(spec, wt, p, device="cpu"), spec)
        bad = [k for k in one if _bits(one[k]) != _bits(got[k][i])]
        assert not bad, (i, bad)
    # two devices: one shard padded (3 lanes over 2), each lane the same
    two = _flat(tshard.simulate_stream_batch(
        spec, wt, teng.stack_params(pts), devices=["cpu", "cpu"]), spec)
    assert all(_bits(two[k]) == _bits(got[k]) for k in got)
    with pytest.raises(ValueError, match="batched params leaf"):
        tshard.simulate_stream_batch(spec, wt, base, devices=["cpu"])


# ---------------------------------------------------------------------------
# sources, overflow and replay
# ---------------------------------------------------------------------------

def test_generator_and_plain_windows_equal_windowed_trace():
    spec, params = teng.make_cloud(n_pm=2, n_vm=8, pm_cores=4.0,
                                   pm_sched="ondemand")
    windows = list(tpipe.gwa_window_stream("das2", 30, 8, max_cores=4,
                                           seed=1))
    arrays = [torch.cat([getattr(w, k) for w in windows])
              for k in ("arrival", "cores", "work", "gid")]
    wt = ttrace.WindowedTrace(*(x.view(len(windows), 8) for x in arrays))
    a = _flat(teng.simulate_stream(spec, wt, params, n_slots=40,
                                   device="cpu"), spec)
    gen = tpipe.gwa_window_stream("das2", 30, 8, max_cores=4, seed=1)
    b = _flat(teng.simulate_stream(spec, gen, params, n_slots=40,
                                   device="cpu"), spec)
    # plain windows (no gid, the last one short) get sequential ids
    plain = [teng.Trace(w.arrival[w.gid >= 0], w.cores[w.gid >= 0],
                        w.work[w.gid >= 0]) for w in windows]
    c = _flat(teng.simulate_stream(spec, iter(plain), params, n_slots=40,
                                   device="cpu"), spec)
    assert a["completion"].shape == (30,) and int(a["n_events"]) > 30
    assert not a["overflow"]
    for other in (b, c):
        assert all(_bits(a[k]) == _bits(other[k]) for k in a)
    with pytest.raises(ValueError, match="exceeds"):
        teng.simulate_stream(spec, iter([_ramp(4), _ramp(6)]), params,
                             device="cpu")
    with pytest.raises(ValueError, match="at least one window"):
        teng.simulate_stream(spec, iter([]), params, device="cpu")


def test_slot_pool_overflow_is_flagged():
    spec, params = teng.make_cloud(n_pm=1, n_vm=2, pm_cores=4.0)
    trace = teng.Trace(np.zeros(8, np.float32), np.full(8, 4.0, np.float32),
                       np.full(8, 40.0, np.float32))
    ok = teng.simulate_stream(spec, ttrace.chunk_trace(trace, 4), params,
                              device="cpu")
    assert not bool(ok.overflow) and ok.completion.shape == (8,)
    small = teng.simulate_stream(spec, ttrace.chunk_trace(trace, 4), params,
                                 n_slots=5, device="cpu")
    assert bool(small.overflow)
    assert int(torch.isfinite(small.completion).sum()) < 8


def test_compaction_overflow_replays_or_raises():
    """A bucket of 2 overflows: a WindowedTrace replays the stream dense
    under a RuntimeWarning (bit-equal to the dense stream), a consumed
    generator raises RuntimeError."""
    spec, params = teng.make_cloud(n_pm=2, n_vm=8, pm_cores=4.0, compact=2)
    trace = ttrace.filter_fitting(ttrace.gwa_like_trace("das2", 24, seed=2),
                                  4.0)
    wt = ttrace.chunk_trace(trace, 8)
    with pytest.warns(RuntimeWarning, match="overflowed"):
        got = _flat(teng.simulate_stream(spec, wt, params, device="cpu"),
                    spec)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        dense = _flat(teng.simulate_stream(teng.dense_spec(spec), wt, params,
                                           device="cpu"), spec)
    assert all(_bits(got[k]) == _bits(dense[k]) for k in dense)
    gen = (wt.window(k) for k in range(wt.n_windows))
    with pytest.raises(RuntimeError, match="generator"):
        teng.simulate_stream(spec, gen, params, device="cpu")


def test_stream_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    spec, params = teng.make_cloud(n_pm=2, n_vm=4, pm_cores=4.0)
    wt = ttrace.chunk_trace(_ramp(4), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teng.simulate_stream(spec, wt, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teng.init_stream(spec, 8, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tshard.simulate_stream_batch(spec, wt, teng.stack_params([params]))
    carry = teng.init_stream(spec, 8, params, device="cpu")
    assert carry.slots.gid.tolist() == [-1] * 8
    assert carry.state.task_state.tolist() == [2] * 8 and carry.compact_ok


# ---------------------------------------------------------------------------
# core/energy.py names
# ---------------------------------------------------------------------------

def test_energy_names_match_reference():
    rng = np.random.RandomState(4)
    C, S = 40, 9
    rates = rng.rand(C).astype(np.float32)
    live = rng.rand(C) < 0.6
    prov = rng.randint(0, S, C).astype(np.int32)
    perf = (rng.rand(S) * 3).astype(np.float32)
    perf[2] = 0.0
    want = np.asarray(jenergy.spreader_utilisation(
        jnp.asarray(rates), jnp.asarray(live), jnp.asarray(prov),
        jnp.asarray(perf)))
    args = [torch.from_numpy(x) for x in (rates, live, prov, perf)]
    got = tenergy.spreader_utilisation(*args)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    lanes = tenergy.spreader_utilisation(*(torch.stack([x, x])
                                           for x in args))
    assert _bits(lanes[1]) == _bits(got)
    for kw in (dict(), dict(pue_minus_one=0.3, base_w=12.5)):
        jm, tm = jenergy.hvac_meter(**kw), tenergy.hvac_meter(**kw)
        signal = np.array([0.0, 100.0, 2500.5], np.float32)
        assert _bits(tm.power(torch.from_numpy(signal))) == _bits(
            jm.power(jnp.asarray(signal)))
        assert isinstance(tm, tenergy.IndirectMeter)
    assert math.isclose(float(tenergy.hvac_meter().coeff), 0.58,
                        rel_tol=1e-6)
