"""Active-set compaction in the port: against live JAX runs of the
reference, and against the port's own dense path, bit for bit.

Against JAX (goldens ``compact8`` / ``compact16`` of tools/make_golden.py
and ``build_compact`` on random states): ``n_events`` and every integer,
bool and state leaf exactly; floats rtol 1e-5 / atol 1e-6; the Kahan low
words not compared.  Against the port's ``compact=0`` run: every leaf bit
for bit, ``energy_lo`` included, since both run in one framework and the
compacted reductions add the same terms in the same order.
"""
from __future__ import annotations

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core.loop import compact as jcpk
from repro.core.trace import synthetic_trace as jsynthetic_trace
from repro_torch.core import engine as teng
from repro_torch.core import machine as mc
from repro_torch.core.loop import compact as cpk
from repro_torch.core.loop.state import add_lane, drop_lane
from repro_torch.core.trace import synthetic_trace
from test_torch_engine import _assert_matches, jflat

SPEC_FIELDS = {f.name for f in dataclasses.fields(teng.CloudSpec)}

# tools/make_golden.py compact8 / compact16
GOLDEN = {
    "compact8": dict(n_pm=3, n_vm=12, pm_cores=4.0, vm_sched="firstfit",
                     pm_sched="ondemand", compact=8),
    "compact16": dict(n_pm=3, n_vm=24, pm_cores=4.0,
                      vm_sched="smallestfirst", pm_sched="ondemand",
                      compact=16),
}


def _sparse_kw():
    return dict(n=20, n_pm=4, spread_s=250.0, length_range=(5.0, 40.0),
                seed=23)


def _sparse_trace():
    kw = _sparse_kw()
    return synthetic_trace(kw.pop("n"), kw.pop("n_pm"), **kw)


def _flat(res, spec) -> dict:
    out = teng.to_numpy(res)
    out.update({f"readings.{k}": v.numpy()
                for k, v in res.readings(spec).items()})
    return out


def _run(spec, params, trace, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("error")     # no overflow replay here
        return teng.simulate(spec, trace, params, device="cpu", **kw)


def _assert_bitwise(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("name", list(GOLDEN))
def test_compact_golden_matches_live_jax_run(name):
    kw = GOLDEN[name]
    spec, params = jeng.make_cloud(**kw)
    assert jcpk.compact_bucket(spec) == kw["compact"]
    tkw = _sparse_kw()
    trace = jsynthetic_trace(tkw.pop("n"), tkw.pop("n_pm"), **tkw)
    res = jeng.simulate(spec, trace, params=params)
    want = jflat(res)
    want.update({f"readings.{k}": np.asarray(v)
                 for k, v in res.readings(spec).items()})
    tspec = teng.CloudSpec(**{k: v for k, v in kw.items() if k in SPEC_FIELDS})
    assert cpk.compact_bucket(tspec, "cpu") == kw["compact"]
    got = _flat(_run(tspec, teng.params_from_numpy(jflat(params)),
                     teng.trace_from_numpy(jflat(trace), device="cpu")), tspec)
    _assert_matches(want, got)


CELLS = {
    "bucket8": dict(GOLDEN["compact8"]),
    "bucket16": dict(GOLDEN["compact16"]),
    # migration flows (net-out -> net-in) go through the bucket
    "consolidate": dict(n_pm=2, n_vm=8, pm_cores=100.0,
                        pm_sched="consolidate", compact=8),
}


def _cell_trace(name):
    if name != "consolidate":
        return _sparse_trace()
    # 2 PMs x 100 cores: PM1 ends up hosting one idle-dominated VM that
    # fits on PM0 (tests/test_migration.py)
    c = np.asarray([60.0, 35.0, 70.0, 25.0], np.float32)
    return teng.trace_from_numpy(dict(
        arrival=np.asarray([0.0, 0.01, 0.02, 230.0], np.float32), cores=c,
        work=np.asarray([2000.0, 200.0, 200.0, 2000.0], np.float32) * c),
        device="cpu")


@pytest.mark.parametrize("name", list(CELLS))
def test_compacted_run_is_bit_equal_to_dense(name):
    spec, params = teng.make_cloud(**CELLS[name])
    assert cpk.compact_bucket(spec, "cpu") == CELLS[name]["compact"]
    trace = _cell_trace(name)
    comp = _flat(_run(spec, params, trace), spec)
    dense = _flat(_run(teng.dense_spec(spec), params, trace), spec)
    _assert_bitwise(dense, comp)
    if name == "consolidate":
        assert np.abs(comp["state.vm_saved_pr"]).sum() > 0   # it migrated


@pytest.mark.parametrize("k", [2, 4])
def test_k_passes_per_host_check_equal_single_passes_compacted(k):
    spec, params = teng.make_cloud(**CELLS["bucket8"])
    trace = _sparse_trace()
    one = _flat(_run(spec, params, trace), spec)
    many = _flat(_run(dataclasses.replace(spec, steps_per_iter=k), params,
                      trace), spec)
    _assert_bitwise(one, many)


def test_compact_overflow_warns_and_replays_dense():
    spec, params = teng.make_cloud(**CELLS["bucket16"])
    trace = _sparse_trace()
    dense = _flat(_run(teng.dense_spec(spec), params, trace), spec)
    tiny = dataclasses.replace(spec, compact=2)
    assert cpk.compact_bucket(tiny, "cpu") == 2
    with pytest.warns(RuntimeWarning, match="overflowed"):
        res = teng.simulate(tiny, trace, params, device="cpu")
    _assert_bitwise(dense, _flat(res, spec))


def test_caller_state_runs_dense_from_the_start():
    """A caller's state runs dense, as in the reference: a bucket far too
    small gives no overflow replay and no warning."""
    spec, params = teng.make_cloud(**CELLS["bucket16"])
    trace = _sparse_trace()
    st0 = teng.init_state(spec, trace, params, device="cpu")
    tiny = dataclasses.replace(spec, compact=2)
    a = _flat(_run(tiny, params, trace, state=st0), spec)
    b = _flat(_run(teng.dense_spec(spec), params, trace), spec)
    _assert_bitwise(a, b)


@pytest.mark.parametrize("n_pm, n_vm, compact", [
    (20, 256, -1), (20, 1024, -1), (3, 12, -1), (6, 120, -1), (500, 4096, -1),
    (1500, 8192, -1), (3, 24, 8), (3, 24, 12), (3, 24, 64), (3, 24, 0),
    (4, 60, 63)])
def test_watermark_rule_matches_reference(n_pm, n_vm, compact):
    want = jcpk.compact_bucket(jeng.CloudSpec(n_pm=n_pm, n_vm=n_vm,
                                              compact=compact))
    got = cpk.compact_bucket(teng.CloudSpec(n_pm=n_pm, n_vm=n_vm,
                                            compact=compact), "cpu")
    assert got == want
    assert cpk.next_pow2(4 * 500 + 32) == 2048 == jcpk.next_pow2(2032)


def test_auto_rule_compacts_the_full_width_cell_only():
    for (n_pm, n_vm), bucket in {(500, 4096): 2048, (20, 1024): 128,
                                 (20, 256): 128, (1500, 8192): 0,
                                 (3, 12): 0}.items():
        spec = teng.CloudSpec(n_pm=n_pm, n_vm=n_vm)
        assert cpk.compact_bucket(spec, "cpu") == bucket, (n_pm, n_vm)


@pytest.mark.parametrize("compact, bucket", [(-1, 0), (0, 0), (2048, 2048),
                                             (100, 128), (8192, 0)])
def test_auto_rule_runs_dense_on_a_card(compact, bucket):
    """On a CUDA device the host-bound pass gains nothing from the bucket,
    so auto runs dense there; an explicit bucket compacts on either
    device."""
    spec = teng.CloudSpec(n_pm=500, n_vm=4096, compact=compact)
    assert cpk.compact_bucket(spec, "cuda") == bucket
    assert cpk.compact_bucket(spec, torch.device("cuda", 0)) == bucket
    if compact != -1:
        assert cpk.compact_bucket(spec, "cpu") == bucket


def _random_state(seed, n_pm=6, n_vm=40, compact=16, p_active=0.2):
    """A JAX state and the port's copy, with random active flows, flow
    endpoints, machine and VM states."""
    rng = np.random.default_rng(seed)
    spec = jeng.CloudSpec(n_pm=n_pm, n_vm=n_vm, compact=compact)
    lay = spec.layout
    F = n_vm + n_pm
    trace = jsynthetic_trace(8, n_pm, seed=seed)
    st = jeng.init_state(spec, trace)
    st = st._replace(
        f_active=jnp.asarray(rng.random(F) < p_active),
        f_prov=jnp.asarray(rng.integers(0, lay.S, F).astype(np.int32)),
        f_cons=jnp.asarray(rng.integers(0, lay.S, F).astype(np.int32)),
        pstate=jnp.asarray(rng.integers(0, 4, n_pm).astype(np.int8)),
        vstage=jnp.asarray(rng.integers(0, mc.N_VM_STATES, n_vm)
                           .astype(np.int8)),
        vm_cores=jnp.asarray(rng.integers(0, 8, n_vm).astype(np.float32)))
    tspec = teng.CloudSpec(n_pm=n_pm, n_vm=n_vm, compact=compact)
    return spec, st, tspec, teng.state_from_numpy(jflat(st), device="cpu")


@pytest.mark.parametrize("seed, p_active", [(0, 0.2), (1, 0.1), (2, 0.3),
                                            (3, 0.0), (4, 0.9)])
def test_build_compact_matches_jax(seed, p_active):
    spec, st, tspec, tst = _random_state(seed, p_active=p_active)
    want = jcpk.build_compact(spec, st)
    # the port builds the buckets of a lane axis: one lane here
    got = drop_lane(cpk.build_compact(tspec, add_lane(tst)))
    for field in cpk.Compact._fields:
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            err_msg=field)
    # the verdict, counted here by hand
    act = tst.f_active.numpy()
    touched = np.unique(np.concatenate([tst.f_prov.numpy()[act],
                                        tst.f_cons.numpy()[act]]))
    assert bool(got.ok) == (act.sum() <= 16 and touched.size <= 16)
    if p_active == 0.9:
        assert not bool(got.ok)


def _leaves(x):
    """The tensor leaves of a (nested) NamedTuple, flattened."""
    if torch.is_tensor(x):
        return [x]
    if x is None or not isinstance(x, tuple):
        return []
    return [t for v in x for t in _leaves(v)]


@pytest.mark.parametrize("complex_power", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_compacted_advance_and_observe_equal_dense(seed, complex_power):
    """One ``advance`` + ``observe`` on a random state: the compacted pass
    (bucketed solve, horizon lanes and provider reduction; the dense Eq. 5
    vector gathered) gives every context and state tensor the dense pass
    gives, bit for bit."""
    from repro_torch.core.loop import advance, observe
    from repro_torch.core.loop.state import StageCtx

    _, _, tspec, tst = _random_state(seed)
    tspec = dataclasses.replace(tspec, complex_power=complex_power)
    params = teng.CloudParams.for_spec(tspec, perf_core=1.25, net_bw=80.0)
    rng = np.random.default_rng(seed + 20)
    F = tst.f_pr.shape[0]
    total = torch.from_numpy(rng.uniform(1.0, 50.0, F).astype(np.float32))
    tst = tst._replace(
        f_total=total, f_pr=total * torch.from_numpy(
            rng.uniform(0.1, 1.0, F).astype(np.float32)),
        f_pl=torch.from_numpy(rng.uniform(0.5, 20.0, F).astype(np.float32)),
        f_release=torch.from_numpy(rng.uniform(-1.0, 1.0, F)
                                   .astype(np.float32)))
    trace = add_lane(synthetic_trace(8, tspec.n_pm, seed=seed).to("cpu"))
    lanes = teng.lane_params(params, 1, "cpu")
    out = {}
    for name, spec in (("comp", tspec), ("dense", teng.dense_spec(tspec))):
        ctx = StageCtx(spec=spec, params=lanes, trace=trace,
                       t_stop=torch.tensor([float("inf")]),
                       arrival_sorted=torch.sort(trace.arrival, -1).values)
        ctx, st = advance.advance(ctx, add_lane(tst))
        ctx, st = observe.observe_stage(ctx, st)
        out[name] = (ctx, st)
    (cc, cs), (dc, ds) = out["comp"], out["dense"]
    assert dc.compact is None and bool(cc.compact.ok)
    assert bool(cc.live.any())
    for field in ("r", "live", "thresh", "done", "delivered", "dt", "t0",
                  "t_new", "has_event", "tick", "view"):
        a, b = _leaves(getattr(cc, field)), _leaves(getattr(dc, field))
        assert len(a) == len(b) > 0, field
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y), field
            assert x.numpy().tobytes() == y.numpy().tobytes(), field
    for x, y in zip(_leaves(cs), _leaves(ds)):
        assert x.numpy().tobytes() == y.numpy().tobytes()


def test_gather_and_scatter_flows_round_trip():
    _, _, tspec, tst = _random_state(5, p_active=0.25)
    tst = add_lane(tst)
    cp = cpk.build_compact(tspec, tst)
    F = tst.f_pr.shape[-1]
    vals = (torch.arange(F, dtype=torch.float32) + 0.5)[None]
    b = cpk.gather_flows(cp, vals, -1.0)
    assert torch.equal(b[~cp.fvalid], torch.full_like(b[~cp.fvalid], -1.0))
    back = cpk.scatter_flows(cp, F, b)
    assert torch.equal(back, torch.where(tst.f_active, vals, 0.0))
