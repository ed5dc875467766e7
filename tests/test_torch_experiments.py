"""The experiments layer: the port's ``experiments.shard``, ``pareto``,
``ensemble`` and ``tournament`` against live JAX runs of the reference on
the same inputs, and the lane split against the port's own unsplit batch.

Rows against the reference: counts, labels and the frontier exactly,
energies, times and means rtol 1e-5.  The split batch against
``simulate_batch``: every leaf bit for bit.  The CPU stands in for the
devices (``devices=["cpu", "cpu"]``), as the reference's tests force two
host devices.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.core import engine as jeng
from repro.core import trace as jtrace
from repro.experiments import ensemble as jens
from repro.experiments import pareto as jpar
from repro.experiments import shard as jshard
from repro.experiments import tournament as jtour
from repro.sched import registry as jreg
from repro_torch.core import engine as teng
from repro_torch.core import trace as ttrace
from repro_torch.experiments import ensemble as tens
from repro_torch.experiments import pareto as tpar
from repro_torch.experiments import shard as tshard
from repro_torch.experiments import tournament as ttour
from repro_torch.sched import registry as treg

RTOL = 1e-5
CLOUD = dict(n_pm=2, n_vm=16, pm_cores=4.0, net_bw=100.0, repo_bw=200.0,
             image_mb=100.0, boot_work=4.0, latency_s=0.0)


def _bits(x) -> bytes:
    return np.asarray(x).tobytes()


def _trace(mod):
    return mod.synthetic_trace(20, parallel=5, seed=0)


def _points(base, n=4):
    """tests/test_experiments.py ``_sweep_inputs``: net_bw and boot_work."""
    return [dataclasses.replace(base, net_bw=50.0 + 25.0 * i,
                                boot_work=2.0 + i) for i in range(n)]


def _assert_rows(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w), set(g) ^ set(w)
        for k, v in w.items():
            if isinstance(v, float) and not isinstance(v, bool):
                np.testing.assert_allclose(g[k], v, rtol=RTOL, err_msg=k)
            else:
                assert g[k] == v, (k, g[k], v)


LABELS = [{"net_bw": 50.0 + 25.0 * i} for i in range(4)]
ENSEMBLE_CLOUD = dict(CLOUD, pm_cores=8.0)
POLICIES = ("alwayson", "ondemand")


def _jax_sweep():
    jspec, jbase = jeng.make_cloud(**CLOUD)
    return jpar.sweep(jspec, _trace(jtrace), _points(jbase), labels=LABELS)


def _jax_tournament():
    jspec, jbase = jeng.make_cloud(**CLOUD)
    return jtour.run(jspec, _trace(jtrace), jbase)


def _jax_ensemble():
    jspec, jbase = jeng.make_cloud(**ENSEMBLE_CLOUD)
    traces = jens.gwa_ensemble("das2", 12, 2, pm_cores=8.0, seed0=3)
    return traces, jens.run_ensemble(
        jspec, traces, [dataclasses.replace(jbase, pm_sched=p)
                        for p in POLICIES],
        labels=[{"policy": p} for p in POLICIES])


# ---------------------------------------------------------------- shard

@pytest.mark.parametrize("n_points", [1, 2, 3, 4, 5, 7, 8, 15, 16])
def test_shard_sizes_match_reference(n_points):
    for n_dev in (1, 2, 3, 4, 8):
        assert tshard.shard_count(n_points, n_dev) == jshard.shard_count(
            n_points, n_dev)
        d = tshard.shard_count(n_points, n_dev)
        assert tshard.pad_rows(n_points, d) == jshard.pad_rows(n_points, d)


@pytest.mark.parametrize("batched", ["params", "trace", "both"])
def test_batch_size_and_flags_match_reference(batched):
    jspec, jbase = jeng.make_cloud(**CLOUD)
    spec, base = teng.make_cloud(**CLOUD)
    jtr, tr = _trace(jtrace), _trace(ttrace)
    jp, tp = jbase, base
    if batched in ("params", "both"):
        jp = jeng.stack_params(_points(jbase, 3))
        tp = teng.stack_params(_points(base, 3))
    if batched in ("trace", "both"):
        jtr = jeng.stack_traces([jtr] * 3)
        tr = teng.stack_traces([tr] * 3)
    assert tshard.batch_flags(spec, tr, tp) == jshard.batch_flags(
        jspec, jtr, jp)
    assert tshard.batch_size(spec, tr, tp) == jshard.batch_size(
        jspec, jtr, jp) == 3
    with pytest.raises(ValueError, match="no batched leaf"):
        tshard.batch_size(spec, _trace(ttrace), base)
    with pytest.raises(ValueError, match="inconsistent"):
        tshard.batch_size(spec, teng.stack_traces([_trace(ttrace)] * 2),
                          teng.stack_params(_points(base, 3)))


@pytest.mark.parametrize("n", [3, 4])
def test_simulate_batch_sharded_two_devices(n):
    """Two devices, the batch even (4) or padded (3 lanes over 2): each lane
    bit-equal to the unsplit ``simulate_batch``; the engine's entry point
    is the same path, and one device is ``simulate_batch`` itself."""
    spec, base = teng.make_cloud(**CLOUD)
    trace = _trace(ttrace)
    params = teng.stack_params(_points(base, n))
    ref = teng.to_numpy(teng.simulate_batch(spec, trace, params,
                                            device="cpu"))
    for got in (tshard.simulate_batch_sharded(spec, trace, params,
                                              devices=["cpu", "cpu"]),
                teng.simulate_batch_sharded(spec, trace, params,
                                            devices=["cpu", "cpu"]),
                tshard.run_batch(spec, trace, params, devices=["cpu"])):
        got = teng.to_numpy(got)
        assert set(got) == set(ref)
        bad = [k for k in ref if _bits(got[k]) != _bits(ref[k])]
        assert not bad, bad
        assert got["n_events"].shape == (n,)


# ---------------------------------------------------------------- pareto

def test_pareto_front_and_grids_match_reference():
    rng = np.random.RandomState(0)
    for shape in ((1, 2), (7, 2), (30, 3)):
        costs = rng.randint(0, 5, shape).astype(np.float64)
        assert (tpar.pareto_front(costs)
                == jpar.pareto_front(costs)).all()
    with pytest.raises(ValueError, match=r"\[N, M\]"):
        tpar.pareto_front(np.zeros(3))
    _, jbase = jeng.make_cloud(**CLOUD)
    _, base = teng.make_cloud(**CLOUD)
    axes = dict(net_bw=[60.0, 125.0], vm_sched=["firstfit", "nonqueuing"],
                image_mb=[50.0, 100.0, 400.0])
    got, want = tpar.param_grid(base, **axes), jpar.param_grid(jbase, **axes)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        for k in axes:
            assert np.asarray(getattr(g, k)) == np.asarray(getattr(w, k)), k
    assert tpar.grid_labels(**axes) == jpar.grid_labels(**axes)
    with pytest.raises(TypeError, match="unknown CloudParams"):
        tpar.param_grid(base, bogus=[1])
    for g, w in zip(tpar.power_scale_grid((0.5, 1.0), (1.0, 1.5)),
                    jpar.power_scale_grid((0.5, 1.0), (1.0, 1.5))):
        assert all(_bits(a) == _bits(b) for a, b in zip(g, w))


def test_sweep_rows_match_reference():
    spec, base = teng.make_cloud(**CLOUD)
    got = tpar.sweep(spec, _trace(ttrace), _points(base),
                     labels=LABELS, devices=["cpu"])
    want = _jax_sweep()
    _assert_rows(got.rows, want.rows)
    assert got.frontier.tolist() == want.frontier.tolist()
    assert any(r["on_frontier"] for r in got.rows)
    with pytest.raises(KeyError, match="no meter reading"):
        tpar.sweep(spec, _trace(ttrace), _points(base, 2),
                   energy_reading="bogus", devices=["cpu"])


# ---------------------------------------------------------------- tournament

def test_tournament_rows_match_reference():
    """Every registered VM x PM pair (3 x 5) on one trace, one batch."""
    spec, base = teng.make_cloud(**CLOUD)
    assert ttour.scheduler_grid() == jtour.scheduler_grid()
    assert len(ttour.scheduler_grid()) == 15
    got = ttour.run(spec, _trace(ttrace), base, devices=["cpu"])
    _assert_rows(got.rows, _jax_tournament().rows)
    coded = ttour.run(spec, _trace(ttrace), base, schedulers=[(0, 1), (2, 4)],
                      devices=["cpu"])
    assert [(r["vm_sched"], r["pm_sched"]) for r in coded.rows] == [
        ("firstfit", "ondemand"), ("smallestfirst", "evacuate")]


def test_registry_name_of_every_code():
    for layer in ("vm", "pm"):
        names = treg.names(layer)
        assert names == jreg.names(layer)
        for code, name in enumerate(names):
            assert treg.name_of(layer, code) == jreg.name_of(layer, code)
            assert treg.name_of(layer, np.int32(code)) == name
        with pytest.raises(KeyError):
            treg.name_of(layer, len(names))


# ---------------------------------------------------------------- ensemble

def test_ensemble_rows_match_reference():
    """Two policies crossed with two das2 replicates, one batch of four."""
    spec, base = teng.make_cloud(**ENSEMBLE_CLOUD)
    traces = tens.gwa_ensemble("das2", 12, 2, pm_cores=8.0, seed0=3)
    got = tens.run_ensemble(
        spec, traces, [dataclasses.replace(base, pm_sched=p)
                       for p in POLICIES],
        labels=[{"policy": p} for p in POLICIES], devices=["cpu"])
    jtraces, want = _jax_ensemble()
    for a, b in zip(traces, jtraces):
        assert all(_bits(x) == _bits(y) for x, y in zip(a[:3], b[:3]))
    _assert_rows(got.rows, want.rows)
    with pytest.raises(ValueError, match="replicates"):
        tens.run_ensemble(spec, traces[:1], [base], devices=["cpu"])
    with pytest.raises(ValueError, match="confidence"):
        tens.run_ensemble(spec, traces, [base], confidence=0.5,
                          devices=["cpu"])
    # no cell to draw the fleet's jobs from: numpy's randint(0) refuses,
    # as in the reference (tests/test_torch_energy_aware.py holds the
    # mixes bit-equal)
    with pytest.raises(ValueError):
        jens.job_mix_ensemble({}, 2)
    with pytest.raises(ValueError):
        tens.job_mix_ensemble({}, 2)


def test_experiment_entry_points_need_a_card_or_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    spec, base = teng.make_cloud(**CLOUD)
    params = teng.stack_params(_points(base, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tshard.run_batch(spec, _trace(ttrace), params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpar.sweep(spec, _trace(ttrace), _points(base, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        tshard.simulate_batch_sharded(spec, _trace(ttrace), params,
                                      devices=["cuda"])
