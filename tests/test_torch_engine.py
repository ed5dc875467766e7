"""The slice as a whole: the port's ``simulate`` + ``readings()`` against a
live JAX run of the reference engine on the same inputs.

The JAX params and trace are flattened to numpy and fed to the port through
``params_from_numpy`` / ``trace_from_numpy``, so both packages run the same
inputs.  Tolerance: ``n_events`` and every integer, bool and state-code
leaf exactly; float leaves rtol 1e-5 / atol 1e-6.  The Kahan low words
(``*.energy_lo``, ``t_c``) are never compared.  Each JAX run is made once
per module.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

from repro.core import engine as jeng
from repro.core import trace as jtrace
from repro_torch.core import engine as teng

RTOL, ATOL = 1e-5, 1e-6
UNCOMPARED = ("energy_lo", "t_c")


def jflat(obj) -> dict:
    return {jax.tree_util.keystr(path).lstrip("."): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(obj)[0]}


def _golden_trace():
    return jtrace.synthetic_trace(16, 4, spread_s=40.0,
                                  length_range=(5.0, 60.0), seed=11)


def _das2_trace():
    return jtrace.filter_fitting(jtrace.gwa_like_trace("das2", 60, seed=3),
                                 64.0)


# (tools/make_golden.py scenario or das2 policy cell) -> (kwargs, t_stop)
GOLDEN = {
    "seq": (dict(n_pm=3, n_vm=12, pm_cores=4.0, vm_sched="firstfit",
                 pm_sched="ondemand"), np.inf),
    "complex_power": (dict(n_pm=3, n_vm=12, pm_cores=4.0, complex_power=True,
                           pm_sched="ondemand"), np.inf),
    "sampled": (dict(n_pm=3, n_vm=12, pm_cores=4.0, metering_period=0.25,
                     pm_sched="alwayson"), np.inf),
    "equal_share": (dict(n_pm=3, n_vm=12, pm_cores=4.0, scheduler="equal",
                         pm_sched="ondemand"), np.inf),
    "t_stop_partial": (dict(n_pm=3, n_vm=12, pm_cores=4.0,
                            pm_sched="ondemand"), 30.0),
}
VM_POLICIES = ("firstfit", "nonqueuing", "smallestfirst")
PM_POLICIES = ("alwayson", "ondemand")
DAS2_SPEC = dict(n_pm=5, n_vm=64, pm_cores=64.0)


def _scenario(name):
    """(spec kwargs, jax params, jax trace, t_stop) of a scenario."""
    if name in GOLDEN:
        kw, t_stop = GOLDEN[name]
        _, params = jeng.make_cloud(**kw)
        return kw, params, _golden_trace(), t_stop
    vm, pm = name.split("/")
    # one CloudSpec for the six policy cells: the codes are traced data, so
    # the reference compiles once
    _, base = jeng.make_cloud(**DAS2_SPEC)
    params = dataclasses.replace(base, vm_sched=vm, pm_sched=pm)
    return DAS2_SPEC, params, _das2_trace(), np.inf


SCENARIOS = list(GOLDEN) + [f"{vm}/{pm}" for vm in VM_POLICIES
                            for pm in PM_POLICIES]


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def get(name):
        if name not in cache:
            kw, params, trace, t_stop = _scenario(name)
            spec = jeng.make_cloud(**kw)[0]
            res = jeng.simulate(spec, trace, params=params, t_stop=t_stop)
            flat = jflat(res)
            flat.update({f"readings.{k}": np.asarray(v)
                         for k, v in res.readings(spec).items()})
            cache[name] = (jflat(params), jflat(trace), flat)
        return cache[name]

    return get


@pytest.mark.parametrize("name", SCENARIOS)
def test_simulate_matches_live_jax_run(name, jax_runs):
    fparams, ftrace, want = jax_runs(name)
    kw, _, _, t_stop = _scenario(name)
    spec_kw = {k: v for k, v in kw.items()
               if k in {f.name for f in dataclasses.fields(teng.CloudSpec)}}
    spec = teng.CloudSpec(**spec_kw)
    params = teng.params_from_numpy(fparams)
    trace = teng.trace_from_numpy(ftrace, device="cpu")
    res = teng.simulate(spec, trace, params, t_stop=t_stop, device="cpu")
    got = teng.to_numpy(res)
    got.update({f"readings.{k}": v.numpy()
                for k, v in res.readings(spec).items()})

    _assert_matches(want, got)


def _assert_matches(want: dict, got: dict):
    assert set(got) == set(want), set(got) ^ set(want)
    assert int(got["n_events"]) == int(want["n_events"])
    assert int(want["n_events"]) > 1
    for k in sorted(want):
        if k.endswith(UNCOMPARED):
            continue
        w, g = want[k], got[k]
        assert g.shape == w.shape, k
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64), err_msg=k)


@pytest.mark.parametrize("steps", [2, 5])
def test_k_passes_per_host_check_equal_single_passes(steps):
    """With K passes between two host reads of the loop condition, the
    passes after the loop has settled are discarded: the result is the
    one-pass-per-read result, bit for bit."""
    kw = dict(n_pm=3, n_vm=12, pm_cores=4.0, pm_sched="ondemand",
              metering_period=0.5)
    trace = teng.trace_from_numpy(jflat(_golden_trace()), device="cpu")
    spec, params = teng.make_cloud(**kw)
    one = teng.to_numpy(teng.simulate(spec, trace, params, device="cpu"))
    spec_k, _ = teng.make_cloud(steps_per_iter=steps, **kw)
    many = teng.to_numpy(teng.simulate(spec_k, trace, params, device="cpu"))
    assert set(one) == set(many)
    for k in one:
        assert one[k].tobytes() == many[k].tobytes(), k
