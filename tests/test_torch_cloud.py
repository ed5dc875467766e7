"""The IaaS facade (``core/cloud.py``) in the port against live JAX runs of
the reference on the CPU, and the port's ``simulate`` against the
sequential DES oracle ``repro.baseline.PyDESCloud``.

The scenarios are those of ``tests/test_engine.py`` that reach the facade,
and a das2 cell with the whole meter stack.  The JAX params and trace are
flattened to numpy and fed to the port, so both run the same inputs.
Integers, bools, state codes, names and ``n_events`` must match exactly;
floats within rtol 1e-5 / atol 1e-6; the Kahan low words are never
compared.  Against PyDESCloud the tolerance is that test's own rtol 2e-3.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baseline import PyDESCloud
from repro.core import cloud as jcloud
from repro.core import engine as jeng
from repro.core import trace as jtrace
from repro_torch.core import cloud as tcloud
from repro_torch.core import engine as teng
from repro_torch.core.loop.state import TASK_DONE, TASK_REJECTED

RTOL, ATOL = 1e-5, 1e-6
UNCOMPARED = ("energy_lo", "t_c")
BASE = dict(n_pm=2, n_vm=16, pm_cores=4.0, net_bw=100.0, repo_bw=200.0,
            image_mb=100.0, boot_work=4.0, latency_s=0.0)


def jflat(obj) -> dict:
    return {jax.tree_util.keystr(path).lstrip("."): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(obj)[0]}


def _trace(arrival, cores, runtime):
    arrival = np.asarray(arrival, np.float32)
    cores = np.asarray(cores, np.float32)
    runtime = np.asarray(runtime, np.float32)
    return jeng.Trace(arrival=jnp.asarray(arrival), cores=jnp.asarray(cores),
                      work=jnp.asarray(runtime * cores))


# name -> (make_cloud kwargs, JAX trace, t_stop of the first run, PM to drop)
SCENARIOS = {
    # tests/test_engine.py::test_deregister_pm_requeues_tasks
    "deregister_requeues": (dict(BASE), lambda: _trace(
        [0.0, 0.0], [4.0, 4.0], [30.0, 30.0]), 10.0, 0),
    # tests/test_engine.py::test_cloud_info_api
    "cloud_info_api": (dict(BASE), lambda: _trace(
        [0.0, 0.0, 0.0], [4.0, 4.0, 4.0], [10.0, 10.0, 10.0]), 5.0, 1),
    # a das2 cell under ondemand with groups and sampled meters
    "das2_ondemand": (dict(n_pm=4, n_vm=32, pm_cores=64.0,
                           pm_sched="ondemand", metering_period=5.0,
                           pm_groups=((0, 1), (2, 3))),
                      lambda: jtrace.filter_fitting(jtrace.gwa_like_trace(
                          "das2", 40, seed=3), 64.0), 300.0, 0),
}


def _both(name):
    """(JAX spec, params, trace), (port spec, params, trace) of a scenario."""
    kw, make_trace, _, _ = SCENARIOS[name]
    kw = dict(kw)
    groups = kw.pop("pm_groups", None)
    jkw, tkw = dict(kw), dict(kw)
    if groups:
        from repro.core.energy import MeterTopology as JTopology
        from repro_torch.core.energy import MeterTopology as TTopology
        jkw["meters"] = JTopology(pm_groups=groups)
        tkw["meters"] = TTopology(pm_groups=groups)
    jspec, jparams = jeng.make_cloud(**jkw)
    jtr = make_trace()
    tspec, _ = teng.make_cloud(**tkw)
    tparams = teng.params_from_numpy(jflat(jparams))
    ttr = teng.trace_from_numpy(jflat(jtr), device="cpu")
    return (jspec, jparams, jtr), (tspec, tparams, ttr)


def _assert_tree(want: dict, got: dict, what: str):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k in sorted(want):
        if k.endswith(UNCOMPARED):
            continue
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.shape == w.shape, (what, k)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64),
                                          err_msg=f"{what} {k}")


def _assert_info(got: dict, want: dict):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        g = got[k]
        if k == "meters":
            assert set(g) == set(w)
            for name in w:
                np.testing.assert_allclose(np.asarray(g[name]),
                                           np.asarray(w[name]), rtol=RTOL,
                                           atol=ATOL, err_msg=name)
        elif isinstance(w, str) or isinstance(w, int) or (
                isinstance(w, list) and w and isinstance(w[0], int)):
            assert type(g) is type(w) and g == w, (k, g, w)
        else:
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.fixture(scope="module")
def runs():
    """Each scenario once in each framework: the run to ``t_stop``, the
    deregistered state and the resumed run; JAX first, then the port."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        _, _, t_stop, pm = SCENARIOS[name]
        (jspec, jparams, jtr), (tspec, tparams, ttr) = _both(name)
        j1 = jeng.simulate(jspec, jtr, params=jparams, t_stop=t_stop)
        jst = jcloud.deregister_pm(jspec, jparams, j1.state, pm, jtr)
        # the reference's simulate donates its state: resume from a copy
        j2 = jeng.simulate(jspec, jtr, params=jparams,
                           state=jax.tree.map(jnp.array, jst))
        want = dict(
            info=jcloud.cloud_info(jspec, jparams, j1.state, jtr),
            dereg=jflat(jst), resumed=jflat(j2),
            events=(jcloud.state_change_events(j1.state, jst),
                    jcloud.state_change_events(jst, j2.state)))
        t1 = teng.simulate(tspec, ttr, tparams, t_stop=t_stop, device="cpu")
        tst = tcloud.deregister_pm(tspec, tparams, t1.state, pm, ttr)
        t2 = teng.simulate(tspec, ttr, tparams, state=tst, device="cpu")
        got = dict(
            info=tcloud.cloud_info(tspec, tparams, t1.state, ttr),
            dereg=teng.to_numpy(tst), resumed=teng.to_numpy(t2),
            events=(tcloud.state_change_events(t1.state, tst),
                    tcloud.state_change_events(tst, t2.state)),
            before=t1.state, state=tst, after=t2.state)
        cache[name] = (want, got)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_cloud_info_matches_jax(name, runs):
    want, got = runs(name)
    _assert_info(got["info"], want["info"])


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_deregister_pm_matches_jax(name, runs):
    want, got = runs(name)
    _assert_tree(want["dereg"], got["dereg"], "deregistered state")
    pm = SCENARIOS[name][3]
    st = got["state"]
    assert int(st.pstate[pm]) == 0 and bool(st.running)
    victims = (got["before"].vm_host == pm) & (got["before"].vstage != 0)
    assert bool(victims.any()) and bool((st.vstage[victims] == 0).all())
    requeued = got["before"].vm_task[victims].long()
    assert bool((st.task_state[requeued] == 0).all())


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_resumed_run_matches_jax(name, runs):
    want, got = runs(name)
    assert int(got["resumed"]["n_events"]) == int(want["resumed"]["n_events"])
    _assert_tree(want["resumed"], got["resumed"], "resumed run")
    ts = got["after"].task_state
    assert bool(((ts == TASK_DONE) | (ts == TASK_REJECTED)).all())


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_state_change_events_match_jax(name, runs):
    want, got = runs(name)
    assert got["events"] == want["events"]
    assert got["events"][1]["tasks_completed"] > 0


def test_reference_expectations_hold_on_the_port(runs):
    """The values tests/test_engine.py asserts, on the port."""
    _, got = runs("cloud_info_api")
    info = got["info"]
    assert info["pm_total"] == 2 and info["pm_running"] == 2
    assert info["vm_hosted"] == 2 and info["queue_len"] == 1
    assert info["capacity_allocated_cores"] == 8.0
    assert info["vm_scheduler"] == "firstfit"
    _, got = runs("deregister_requeues")
    assert bool((got["after"].task_state == TASK_DONE).all())


def test_sched_name_of_codes():
    from repro_torch.sched import registry
    assert tcloud._sched_name(1, "pm") == "ondemand"
    assert tcloud._sched_name(torch.tensor(2, dtype=torch.int32),
                              "vm") == "smallestfirst"
    p = registry.register("vm", "cloud_test_noop", lambda *a: a[-1])
    try:
        assert tcloud._sched_name(p.code, "vm") == "cloud_test_noop"
    finally:
        registry.unregister("vm", p.code)
    assert tcloud._sched_name(p.code, "vm") == "<unregistered>"
    assert jcloud._sched_name(p.code, "vm") == "<unregistered>"


def test_simulate_matches_pydes_oracle():
    """tests/test_engine.py::test_engine_matches_pydes_oracle on the port."""
    spec, params = teng.make_cloud(**BASE)
    rng = np.random.RandomState(3)
    n = 24
    arrival = np.sort(rng.uniform(0, 30, n)).astype(np.float32)
    cores = rng.choice([1.0, 2.0, 4.0], n,
                       p=[0.6, 0.3, 0.1]).astype(np.float32)
    runtime = rng.uniform(5, 40, n).astype(np.float32)
    tr = teng.Trace(arrival=torch.from_numpy(arrival),
                    cores=torch.from_numpy(cores),
                    work=torch.from_numpy(runtime * cores))
    res = teng.simulate(spec, tr, params, device="cpu")
    oracle = PyDESCloud(n_pm=2, pm_cores=4.0, net_bw=100.0, repo_bw=200.0,
                        image_mb=100.0, boot_work=4.0).run(
        arrival, cores, runtime * cores)
    got = res.completion.numpy()
    want = oracle["completion"]
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-3)
    np.testing.assert_allclose(float(res.energy.sum()), oracle["energy"],
                               rtol=2e-3)
