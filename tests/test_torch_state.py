"""The port's configuration half against the JAX package: trace generators
bit-equal, ``init_state`` leaf-equal for every golden scenario's spec, and
the numpy round trip of params, traces and states."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import trace as jtrace
from repro_torch.core import engine as teng
from repro_torch.core import trace as ttrace


def jflat(obj) -> dict:
    """A JAX pytree as ``{dotted field name: numpy array}``."""
    return {jax.tree_util.keystr(path).lstrip("."): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(obj)[0]}


def assert_same_leaves(want: dict, got: dict):
    assert set(want) == set(got), set(want) ^ set(got)
    for k in want:
        w, g = want[k], got[k]
        assert g.shape == w.shape, k
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


def assert_bit_equal_trace(jt, tt):
    for name in ("arrival", "cores", "work"):
        a = np.asarray(getattr(jt, name))
        b = np.asarray(getattr(tt, name))
        assert a.dtype == b.dtype == np.float32, name
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), name


@pytest.mark.parametrize("kw", [
    dict(n_tasks=16, parallel=4, spread_s=40.0, length_range=(5.0, 60.0),
         seed=11),
    dict(n_tasks=20, parallel=4, spread_s=250.0, length_range=(5.0, 40.0),
         seed=23),
    dict(n_tasks=100, parallel=7, cores=3, perf_core=1.5, seed=2),
])
def test_synthetic_trace_bit_equal(kw):
    assert_bit_equal_trace(jtrace.synthetic_trace(**kw),
                           ttrace.synthetic_trace(**kw))


@pytest.mark.parametrize("family", sorted(jtrace.GWA_FAMILIES))
def test_gwa_like_trace_bit_equal(family):
    assert (dataclasses.asdict(ttrace.GWA_FAMILIES[family])
            == dataclasses.asdict(jtrace.GWA_FAMILIES[family]))
    for seed in (0, 7):
        jt = jtrace.gwa_like_trace(family, 300, seed=seed)
        tt = ttrace.gwa_like_trace(family, 300, seed=seed)
        assert_bit_equal_trace(jt, tt)
        assert_bit_equal_trace(jtrace.filter_fitting(jt, 16.0),
                               ttrace.filter_fitting(tt, 16.0))


# the specs of tools/make_golden.py's dense scenarios
GOLDEN_SPECS = {
    "seq": dict(n_pm=3, n_vm=12, pm_cores=4.0, vm_sched="firstfit",
                pm_sched="ondemand"),
    "batched": dict(n_pm=3, n_vm=12, pm_cores=4.0),
    "complex_power": dict(n_pm=3, n_vm=12, pm_cores=4.0, complex_power=True,
                          pm_sched="ondemand"),
    "sampled": dict(n_pm=3, n_vm=12, pm_cores=4.0, metering_period=0.25,
                    pm_sched="alwayson"),
    "migration_policy": dict(n_pm=4, n_vm=12, pm_cores=4.0,
                             pm_sched="consolidate",
                             consolidate_idle_frac=0.3),
    "equal_share": dict(n_pm=3, n_vm=12, pm_cores=4.0, scheduler="equal",
                        pm_sched="ondemand"),
    "t_stop_partial": dict(n_pm=3, n_vm=12, pm_cores=4.0,
                           pm_sched="ondemand"),
    "streaming_windows": dict(n_pm=3, n_vm=12, pm_cores=4.0,
                              vm_sched="smallestfirst", pm_sched="ondemand",
                              metering_period=0.25),
}


@pytest.mark.parametrize("name", sorted(GOLDEN_SPECS))
def test_init_state_leaves_equal(name):
    kw = GOLDEN_SPECS[name]
    jt = jtrace.synthetic_trace(16, 4, spread_s=40.0,
                                length_range=(5.0, 60.0), seed=11)
    tt = ttrace.synthetic_trace(16, 4, spread_s=40.0,
                                length_range=(5.0, 60.0), seed=11)
    jspec, jparams = jeng.make_cloud(**kw)
    tspec, tparams = teng.make_cloud(**kw)
    assert_same_leaves(jflat(jparams), teng.to_numpy(tparams))
    want = jflat(jeng.init_state(jspec, jt, jparams))
    got = teng.to_numpy(teng.init_state(tspec, tt, tparams, device="cpu"))
    assert_same_leaves(want, got)


def test_from_numpy_round_trip():
    jt = jtrace.gwa_like_trace("das2", 50, seed=3)
    jspec, jparams = jeng.make_cloud(n_pm=5, n_vm=64, pm_cores=64.0,
                                     metering_period=2.0, pm_sched="ondemand",
                                     vm_sched="smallestfirst")
    jst = jeng.init_state(jspec, jt, jparams)
    fp, ft, fs = jflat(jparams), jflat(jt), jflat(jst)

    params = teng.params_from_numpy(fp)
    assert params.vm_sched == 2 and params.pm_sched == 1
    assert_same_leaves(fp, teng.to_numpy(params))
    trace = teng.trace_from_numpy(ft, device="cpu")
    assert_same_leaves(ft, teng.to_numpy(trace))
    state = teng.state_from_numpy(fs, device="cpu")
    assert state.vstage.dtype == torch.int8
    assert state.f_prov.dtype == torch.int32
    assert_same_leaves(fs, teng.to_numpy(state))

    # a state built from numpy runs like the port's own initial state
    tspec, _ = teng.make_cloud(n_pm=5, n_vm=64, pm_cores=64.0)
    a = teng.simulate(tspec, trace, params, state=state, device="cpu")
    b = teng.simulate(tspec, trace, params, device="cpu")
    assert_same_leaves(teng.to_numpy(b), teng.to_numpy(a))


def test_live_mask_matches_reference():
    from repro.core.arrays import live_mask as jlive
    from repro_torch.core.arrays import Consumptions, live_mask as tlive
    rng = np.random.RandomState(5)
    n = 64
    f = dict(p_u=rng.rand(n).astype(np.float32) * (rng.rand(n) < 0.5),
             p_r=rng.rand(n).astype(np.float32) * (rng.rand(n) < 0.5),
             active=rng.rand(n) < 0.7,
             t_release=(rng.rand(n) * 2).astype(np.float32))
    jc = type("C", (), {k: jax.numpy.asarray(v) for k, v in f.items()})
    got = tlive(Consumptions(**{k: torch.from_numpy(v) for k, v in f.items()}),
                torch.tensor(1.0))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jlive(jc, jax.numpy.float32(1.0))))


def test_skipped_gates_are_identity():
    """The port runs every policy body where the reference skips it behind
    its trigger: a False trigger must leave the state bit for bit."""
    from repro_torch.core.loop.state import StageCtx
    from repro_torch.sched import registry
    trace = ttrace.synthetic_trace(8, 4, seed=1)
    trace = trace._replace(arrival=trace.arrival + 100.0)   # nothing queued
    for pm_sched in ("alwayson", "ondemand"):
        spec, params = teng.make_cloud(n_pm=3, n_vm=8, pm_cores=4.0,
                                       pm_sched=pm_sched)
        ttr = trace.to("cpu")
        st = teng.init_state(spec, ttr, params, device="cpu")
        ctx = StageCtx(spec=spec, params=params, trace=ttr,
                       t_stop=torch.tensor(np.inf))
        for layer in ("pm", "vm"):
            code = params.pm_sched if layer == "pm" else params.vm_sched
            assert not bool(registry.trigger_branches(layer, ctx)[code](st))
            after = registry.stage_branches(layer, ctx)[code](st)
            assert_same_leaves(teng.to_numpy(st), teng.to_numpy(after))


def test_segment_sum_where_drops_only_zero_rows():
    from repro_torch.core.arrays import segment_sum
    rng = np.random.RandomState(4)
    n, rows = 7, 300
    ids = torch.from_numpy(rng.randint(0, n, rows).astype(np.int32))
    keep = torch.from_numpy(rng.rand(rows) < 0.3)
    data = torch.where(keep[:, None],
                       torch.from_numpy(rng.rand(rows, 2).astype(np.float32)),
                       0.0)
    full = segment_sum(data, ids, n)
    assert torch.equal(segment_sum(data, ids, n, where=keep), full)
    assert segment_sum(data, ids, n, where=keep).shape == (n, 2)
