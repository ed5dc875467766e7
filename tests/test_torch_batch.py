"""Batched scenarios: the port's ``simulate_batch`` against a live JAX run of
the reference's ``engine.simulate_batch`` on the same inputs, and each lane
against the port's own single ``simulate`` of that lane.

Cases: golden ``batched`` (tools/make_golden.py: six lanes over every VM
and PM policy code, ``net_bw`` swept) and the three cases of
tests/test_batch_sweep.py (a params sweep with a meter-less lane in a
metered batch, the scheduler matrix, batched traces).  The JAX batch is
flattened to numpy and fed to the port through ``params_from_numpy`` /
``trace_from_numpy``.  Against JAX: ``n_events`` and every integer, bool
and state leaf exactly, floats rtol 1e-5 / atol 1e-6, the Kahan low words
(``*.energy_lo``, ``t_c``) never compared.  Against the port's single run:
every leaf bit for bit.  Each JAX run is made once per module.
"""
from __future__ import annotations

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import trace as jtrace
from repro_torch.core import engine as teng
from repro_torch.core.loop.state import drop_lane
from test_torch_engine import RTOL, ATOL, UNCOMPARED, jflat

SPEC_FIELDS = {f.name for f in dataclasses.fields(teng.CloudSpec)}


def _golden_batched():
    """tools/make_golden.py ``batched``: every PM and VM code at least once."""
    trace = jtrace.synthetic_trace(16, 4, spread_s=40.0,
                                   length_range=(5.0, 60.0), seed=11)
    kw = dict(n_pm=3, n_vm=12, pm_cores=4.0)
    _, base = jeng.make_cloud(**kw)
    pts = [dataclasses.replace(base, net_bw=float(80.0 + 20.0 * i),
                               vm_sched=i % len(jeng.VM_SCHEDULERS),
                               pm_sched=i % len(jeng.PM_SCHEDULERS))
           for i in range(6)]
    return kw, trace, jeng.stack_params(pts)


def _sweep_kw(**kw):
    """tests/test_batch_sweep.py ``_cloud``."""
    base = dict(n_pm=2, n_vm=16, pm_cores=4.0, net_bw=100.0, repo_bw=200.0,
                image_mb=100.0, boot_work=4.0, latency_s=0.0)
    base.update(kw)
    return base


def _sweep_trace(arrival, cores, runtime):
    arrival, cores, runtime = (jnp.asarray(x, jnp.float32)
                               for x in (arrival, cores, runtime))
    return jeng.Trace(arrival=arrival, cores=cores, work=runtime * cores)


def _params_sweep():
    """Four points varying several knobs; point 0 is meter-less (period 0)
    inside a metered batch."""
    kw = _sweep_kw(n_pm=2, n_vm=8)
    _, params = jeng.make_cloud(**kw)
    pts = [dataclasses.replace(
        params, net_bw=jnp.float32(50.0 + 25.0 * i),
        boot_work=jnp.float32(2.0 + i), image_mb=jnp.float32(50.0 + 25.0 * i),
        metering_period=jnp.float32(0.0 if i == 0 else 0.5 * i))
        for i in range(4)]
    trace = _sweep_trace([0.0, 1.0, 2.0, 3.0, 8.0], [1.0, 2.0, 4.0, 1.0, 2.0],
                         [10.0, 7.0, 3.0, 12.0, 5.0])
    return kw, trace, jeng.stack_params(pts)


def _scheduler_matrix():
    """The VM x PM scheduler matrix as one batch of 15 lanes."""
    kw = _sweep_kw(n_pm=1, n_vm=8)
    _, params = jeng.make_cloud(**kw)
    pts = [dataclasses.replace(params, vm_sched=v, pm_sched=p)
           for v in jeng.VM_SCHEDULERS for p in jeng.PM_SCHEDULERS]
    trace = _sweep_trace([0.0, 0.0, 0.5], [4.0, 4.0, 1.0], [10.0, 10.0, 2.0])
    return kw, trace, jeng.stack_params(pts)


def _batched_traces():
    """Three stacked traces under one (unbatched) params point."""
    kw = _sweep_kw(n_pm=1, n_vm=32)
    _, params = jeng.make_cloud(**kw)
    traces = [jtrace.synthetic_trace(24, parallel=6, seed=s)
              for s in (0, 1, 2)]
    return kw, jeng.stack_traces(traces), params


CASES = {"golden_batched": _golden_batched, "params_sweep": _params_sweep,
         "scheduler_matrix": _scheduler_matrix,
         "batched_traces": _batched_traces}


def _port(kw):
    return teng.CloudSpec(**{k: v for k, v in kw.items() if k in SPEC_FIELDS})


def _flat(res, spec) -> dict:
    out = teng.to_numpy(res)
    out.update({f"readings.{k}": v.numpy()
                for k, v in res.readings(spec).items()})
    return out


@pytest.fixture(scope="module")
def runs():
    """Per case: the port's inputs and the JAX batch's flattened result,
    the JAX run made once."""
    cache = {}

    def get(name):
        if name not in cache:
            kw, trace, params = CASES[name]()
            spec = jeng.make_cloud(**kw)[0]
            res = jeng.simulate_batch(spec, trace, params)
            want = jflat(res)
            want.update({f"readings.{k}": np.asarray(v)
                         for k, v in res.readings(spec).items()})
            cache[name] = (kw, teng.params_from_numpy(jflat(params)),
                           teng.trace_from_numpy(jflat(trace), device="cpu"),
                           want)
        return cache[name]

    return get


@pytest.fixture(scope="module")
def port_batches(runs):
    """Per case: the port's batched result, run once."""
    cache = {}

    def get(name):
        if name not in cache:
            kw, params, trace, _ = runs(name)
            spec = _port(kw)
            cache[name] = teng.simulate_batch(spec, trace, params,
                                              device="cpu")
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_simulate_batch_matches_live_jax(name, runs, port_batches):
    kw, _, _, want = runs(name)
    got = _flat(port_batches(name), _port(kw))
    assert set(got) == set(want), set(got) ^ set(want)
    B = want["n_events"].shape[0]
    assert B > 1 and (want["n_events"] > 1).all()
    np.testing.assert_array_equal(got["n_events"], want["n_events"])
    for k in sorted(want):
        w, g = want[k], got[k]
        # every leaf, readings included, leads with the batch
        assert g.shape == w.shape and g.shape[:1] == (B,), k
        if k.endswith(UNCOMPARED):
            continue
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64), err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_every_lane_equals_its_single_run(name, runs, port_batches):
    """Lane i of the batch is ``simulate`` of lane i's inputs, bit for bit
    (the lanes share every pass, and a settled lane keeps its state)."""
    kw, params, trace, _ = runs(name)
    spec = _port(kw)
    batch = _flat(port_batches(name), spec)
    B = batch["n_events"].shape[0]
    for i in range(B):
        p_i = _lane_of_params(params, i)
        t_i = teng.Trace(*(x[i] if x.dim() == 2 else x for x in trace[:3]))
        single = _flat(teng.simulate(spec, t_i, p_i, device="cpu"), spec)
        assert set(single) == set(batch)
        for k in single:
            assert single[k].tobytes() == batch[k][i].tobytes(), (i, k)


def _lane_of_params(params, i):
    """Lane ``i`` of a (possibly batched) CloudParams, as one scenario's."""
    def lane(x, dims):
        return x[i] if torch.is_tensor(x) and x.dim() > dims else x

    kw = {f.name: lane(getattr(params, f.name), 0)
          for f in dataclasses.fields(teng.CloudParams)
          if f.name not in ("power", "meter")}
    kw["power"] = teng.PowerStateTable(*(lane(x, 1) for x in params.power))
    kw["meter"] = teng.MeterParams(lane(params.meter.indirect_base, 1),
                                   lane(params.meter.indirect_coeff, 1))
    return teng.CloudParams(**kw)


def test_stack_params_and_traces_match_the_reference():
    """``stack_params`` / ``stack_traces`` give the reference's leaves:
    f32 scalars, int32 codes, the table and meter rows [B, ...]."""
    _, _, jparams = _golden_batched()
    _, base = teng.make_cloud(n_pm=3, n_vm=12, pm_cores=4.0)
    pts = [dataclasses.replace(base, net_bw=float(80.0 + 20.0 * i),
                               vm_sched=i % 3, pm_sched=i % 5)
           for i in range(6)]
    got = teng.to_numpy(teng.stack_params(pts))
    want = jflat(jparams)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    traces = [jtrace.synthetic_trace(24, parallel=6, seed=s)
              for s in (0, 1, 2)]
    from repro_torch.core import trace as ttrace
    tt = teng.stack_traces([ttrace.synthetic_trace(24, parallel=6, seed=s)
                            for s in (0, 1, 2)])
    jt = jeng.stack_traces(traces)
    for k in ("arrival", "cores", "work"):
        assert getattr(tt, k).shape == (3, 24)
        np.testing.assert_array_equal(getattr(tt, k).numpy(),
                                      np.asarray(getattr(jt, k)))
    assert tt.n == 24


def test_readings_carry_the_batch_axis(runs, port_batches):
    kw, _, _, _ = runs("params_sweep")
    spec = _port(kw)
    res = port_batches("params_sweep")
    rd = res.readings(spec)
    B = res.n_events.shape[0]
    assert rd["pm"].shape == (B, spec.n_pm)
    assert rd["vm"].shape == (B, spec.n_vm)
    assert rd["iaas_total"].shape == rd["vm_unattributed"].shape == (B,)
    assert rd["hvac"].shape == (B,)
    # lane 0 is meter-less: no sampled energy; the others sample
    assert float(rd["pm_sampled"][0].abs().sum()) == 0.0
    assert (rd["pm_sampled"][1:].sum(-1) > 0).all()


def test_batch_errors_match_the_reference():
    spec, params = teng.make_cloud(n_pm=2, n_vm=4, pm_cores=4.0)
    trace = teng.Trace(np.zeros(2, np.float32), np.ones(2, np.float32),
                       np.ones(2, np.float32))
    with pytest.raises(ValueError, match="batched leaf"):
        teng.simulate_batch(spec, trace, params, device="cpu")
    with pytest.raises(ValueError, match="equal-length"):
        teng.stack_traces([trace, teng.Trace(*(x[:1] for x in trace[:3]))])
    with pytest.raises(ValueError, match="at least one"):
        teng.stack_traces([])
    with pytest.raises(ValueError, match="at least one"):
        teng.stack_params([])
    two = teng.stack_traces([trace, trace])
    three = teng.stack_params([params] * 3)
    with pytest.raises(ValueError, match="batch size"):
        teng.simulate_batch(spec, two, three, device="cpu")
    lop = dataclasses.replace(params, net_bw=torch.tensor([100.0, 125.0]),
                              image_mb=torch.tensor([1.0, 2.0, 3.0]))
    with pytest.raises(ValueError, match="batch size"):
        teng.simulate_batch(spec, trace, lop, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        dataclasses.replace(params, pm_sched=np.array([0, 9]))
    # the reference refuses the same inputs
    jspec, jparams = jeng.make_cloud(n_pm=2, n_vm=4, pm_cores=4.0)
    jtr = jeng.Trace(*(jnp.asarray(x) for x in trace[:3]))
    with pytest.raises(ValueError, match="batched leaf"):
        jeng.simulate_batch(jspec, jtr, jparams)
    with pytest.raises(ValueError, match="equal-length"):
        jeng.stack_traces([jtr, jeng.Trace(*(x[:1] for x in jtr[:3]))])
    with pytest.raises(ValueError):
        jeng.simulate_batch(jspec, jeng.stack_traces([jtr, jtr]),
                            jeng.stack_params([jparams] * 3))


def _overflow_batch():
    """A 10-PM cloud with an explicit bucket of 8 and two lanes: lane 0's
    bursts keep at most a few flows active, lane 1 (every task at t = 0)
    activates more flows than the bucket holds."""
    spec, base = teng.make_cloud(n_pm=10, n_vm=40, pm_cores=4.0,
                                 pm_sched="ondemand", compact=8)
    sparse = np.arange(12, dtype=np.float32) * 60.0
    burst = np.zeros(12, np.float32)
    cores = np.ones(12, np.float32)
    work = np.full(12, 20.0, np.float32)
    trace = teng.stack_traces([teng.Trace(sparse, cores, work),
                               teng.Trace(burst, cores, work)])
    return spec, base, trace


def test_one_lane_overflowing_replays_the_whole_batch_dense():
    """As in the reference: one lane's bucket overflow replays the whole
    batch with compact=0 under a RuntimeWarning, bit-equal to the dense
    batch; the lane that fits alone runs compacted without a replay."""
    spec, params, trace = _overflow_batch()
    with pytest.warns(RuntimeWarning, match="overflowed"):
        got = teng.to_numpy(teng.simulate_batch(spec, trace, params,
                                                device="cpu"))
    dense = teng.to_numpy(teng.simulate_batch(teng.dense_spec(spec), trace,
                                              params, device="cpu"))
    for k in dense:
        assert got[k].tobytes() == dense[k].tobytes(), k
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        lane0 = teng.simulate(spec, teng.Trace(*(x[0] for x in trace[:3])),
                              params, device="cpu")
    for k, v in teng.to_numpy(lane0).items():
        assert v.tobytes() == dense[k][0].tobytes(), k


def test_batch_of_one_lane_is_simulate():
    """``simulate`` is the batch of one lane: a batch of one gives its
    result with a leading axis of 1, bit for bit."""
    kw, trace, _ = _golden_batched()
    spec, params = teng.make_cloud(**kw, pm_sched="ondemand")
    tt = teng.trace_from_numpy(jflat(trace), device="cpu")
    one = teng.to_numpy(teng.simulate(spec, tt, params, device="cpu"))
    batch = teng.simulate_batch(spec, tt, teng.stack_params([params]),
                                device="cpu")
    got = teng.to_numpy(drop_lane(batch))
    assert set(got) == set(one)
    for k in one:
        assert got[k].tobytes() == one[k].tobytes(), k
