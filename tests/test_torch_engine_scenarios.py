"""Scenarios beyond ``tests/test_torch_engine.py``: a cloud above 5 PMs,
non-default meter topologies, indirect meters on every signal, and equal
sharing under a stop time, each through the port's ``simulate`` +
``readings()`` against a live JAX run on the same inputs.

Inputs reach the port through ``params_from_numpy`` / ``trace_from_numpy``.
Tolerance: ``n_events`` and every integer, bool and state leaf exactly;
floats rtol 1e-5 / atol 1e-6; the Kahan low words not compared.  The two
20 PM x 256 VM cells compact under the auto rule (bucket 128, half of the
276 flows is 138), so they also hold compaction against JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.core import energy as jenergy
from repro.core import engine as jeng
from repro.core import trace as jtrace
from repro_torch.core import energy as tenergy
from repro_torch.core import engine as teng
from repro_torch.core.loop import compact as cpk
from test_torch_engine import _assert_matches, jflat

# (name, signal, base W, coefficient): one indirect meter on each signal
INDIRECT = (("hvac", "SIGNAL_IT_POWER", 0.0, 0.58),
            ("mgmt", "SIGNAL_VM_COUNT", 15.0, 2.5),
            ("admission", "SIGNAL_QUEUE_LEN", 5.0, 1.25))


def _topology(energy, vm_direct=True, pm_groups=(), indirect=None):
    if indirect is None:
        return energy.MeterTopology(vm_direct=vm_direct, pm_groups=pm_groups)
    return energy.MeterTopology(
        vm_direct=vm_direct, pm_groups=pm_groups,
        indirect=tuple(energy.IndirectMeterSpec(
            name=n, signal=getattr(energy, s), base_w=b, coeff=c)
            for n, s, b, c in indirect))


def _golden_trace():
    return jtrace.synthetic_trace(16, 4, spread_s=40.0,
                                  length_range=(5.0, 60.0), seed=11)


def _das2_trace():
    return jtrace.filter_fitting(jtrace.gwa_like_trace("das2", 300, seed=3),
                                 64.0)


DAS2 = dict(n_pm=20, n_vm=256, pm_cores=64.0)
GROUPS = dict(n_pm=4, n_vm=16, pm_cores=4.0, pm_sched="ondemand")
# name -> (cloud kwargs, meter topology kwargs, trace, t_stop)
SCENARIOS = {
    "das2_20x256_ondemand": (dict(DAS2, pm_sched="ondemand"), None,
                             _das2_trace, np.inf),
    "das2_20x256_nonqueuing_complex_sampled": (
        dict(DAS2, pm_sched="ondemand", vm_sched="nonqueuing",
             complex_power=True, metering_period=5.0), None, _das2_trace,
        np.inf),
    "groups_4x16_three_indirect": (
        GROUPS, dict(pm_groups=((0, 1), (2, 3)), indirect=INDIRECT),
        _golden_trace, np.inf),
    "groups_4x16_no_vm_meters": (
        GROUPS, dict(pm_groups=((0, 1), (2, 3)), vm_direct=False,
                     indirect=()), _golden_trace, np.inf),
    "equal_smallestfirst_alwayson_t_stop": (
        dict(n_pm=3, n_vm=12, pm_cores=4.0, scheduler="equal",
             vm_sched="smallestfirst", pm_sched="alwayson"), None,
        _golden_trace, 45.0),
}


def _clouds(name):
    kw, meters, trace_fn, t_stop = SCENARIOS[name]
    jkw, tkw = dict(kw), dict(kw)
    if meters is not None:
        jkw["meters"] = _topology(jenergy, **meters)
        tkw["meters"] = _topology(tenergy, **meters)
    return jeng.make_cloud(**jkw), tkw, trace_fn(), t_stop


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_live_jax_run(name):
    (spec, params), tkw, trace, t_stop = _clouds(name)
    res = jeng.simulate(spec, trace, params=params, t_stop=t_stop)
    want = jflat(res)
    want.update({f"readings.{k}": np.asarray(v)
                 for k, v in res.readings(spec).items()})

    fields = {f.name for f in dataclasses.fields(teng.CloudSpec)}
    tspec = teng.CloudSpec(**{k: v for k, v in tkw.items() if k in fields})
    assert cpk.compact_bucket(tspec, "cpu") == (
        128 if name.startswith("das2") else 0)
    tparams = teng.params_from_numpy(jflat(params))
    got_res = teng.simulate(tspec, teng.trace_from_numpy(jflat(trace),
                                                         device="cpu"),
                            tparams, t_stop=t_stop, device="cpu")
    got = teng.to_numpy(got_res)
    got.update({f"readings.{k}": v.numpy()
                for k, v in got_res.readings(tspec).items()})
    assert set(res.readings(spec)) == set(got_res.readings(tspec))
    _assert_matches(want, got)
