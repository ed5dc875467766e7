"""The migrating PM policies (``consolidate``, ``defrag``, ``evacuate``) and
live migration in the port, against live JAX runs of the reference and
against the reference's own policy invariants.

Inputs go to the port through ``params_from_numpy`` / ``trace_from_numpy``
/ ``state_from_numpy``.  Tolerance: ``n_events`` and every integer, bool
and state leaf exactly; floats rtol 1e-5 / atol 1e-6; the Kahan low words
(``*.energy_lo``, ``t_c``) are not compared.

The cells avoid traces whose event count hangs on the last bit of the
clock: XLA:CPU contracts the drain's ``f_pr - r * dt`` into one fused
multiply-add where the port rounds twice, and on the two-PM traces of the
reference's ``tests/test_policies.py`` that one-ulp residual splits one
event in two (ROADMAP.md queue 3).  Those traces serve the port-only
invariants below, which compare the port with itself.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import trace as jtrace
from repro.core.energy import tenant_energy as jtenant_energy
from repro_torch.core import engine as teng
from repro_torch.core import machine as mc
from repro_torch.core.energy import PM_OFF, PM_RUNNING, PM_SWITCHING_OFF
from repro_torch.core.energy import tenant_energy
from repro_torch.core.loop import migrate
from repro_torch.core.loop.state import TASK_DONE, add_lane, drop_lane
from repro_torch.sched import registry
from repro_torch.sched.policies import consolidate, evacuate
from test_torch_engine import _assert_matches, jflat

SPEC_FIELDS = {f.name for f in dataclasses.fields(teng.CloudSpec)}


def _np_trace(arrival, cores, runtime) -> dict:
    c = np.asarray(cores, np.float32)
    return dict(arrival=np.asarray(arrival, np.float32), cores=c,
                work=(np.asarray(runtime, np.float32) * c))


def _straggler_trace(waves=2) -> dict:
    """Per wave, first-fit packs four 16-core tasks per PM; one per PM is a
    long straggler, so the drained hosts consolidate."""
    arrival, cores, runtime = [], [], []
    for w in range(waves):
        for i in range(16):
            arrival.append(w * 5000.0 + 0.01 * i)
            cores.append(16.0)
            runtime.append(4000.0 if i % 4 == 3 else 200.0)
    return _np_trace(arrival, cores, runtime)


def _evac_trace() -> dict:
    """2 PMs x 100 cores: PM1 ends up hosting two small VMs next to a busy
    PM0 that fits both (tests/test_policies.py)."""
    return _np_trace([0.0, 0.005, 0.01, 0.02, 0.03],
                     [70.0, 30.0, 60.0, 15.0, 10.0],
                     [2000.0, 250.0, 200.0, 2000.0, 2000.0])


def _consolidation_trace() -> dict:
    """2 PMs x 100 cores: PM1 ends up hosting one idle-dominated VM that
    fits on PM0 (tests/test_migration.py)."""
    return _np_trace([0.0, 0.01, 0.02, 230.0], [60.0, 35.0, 70.0, 25.0],
                     [2000.0, 200.0, 200.0, 2000.0])


# ---------------------------------------------------------------------------
# against live JAX runs
# ---------------------------------------------------------------------------

STRAGGLER = dict(n_pm=4, n_vm=32, pm_cores=64.0)
DAS2 = dict(n_pm=5, n_vm=64, pm_cores=64.0)
CELLS = {
    # tools/make_golden.py migration_policy
    "migration_policy": (dict(n_pm=4, n_vm=12, pm_cores=4.0,
                              pm_sched="consolidate",
                              consolidate_idle_frac=0.3), "golden"),
    "straggler/consolidate": (dict(STRAGGLER, pm_sched="consolidate"),
                              "straggler"),
    "straggler/defrag": (dict(STRAGGLER, pm_sched="defrag"), "straggler"),
    "straggler/evacuate": (dict(STRAGGLER, pm_sched="evacuate"),
                           "straggler"),
    "das2/defrag": (dict(DAS2, pm_sched="defrag"), "das2"),
    "das2/evacuate": (dict(DAS2, pm_sched="evacuate"), "das2"),
}


def _jax_trace(name):
    if name == "golden":
        return jtrace.synthetic_trace(16, 4, spread_s=40.0,
                                      length_range=(5.0, 60.0), seed=11)
    if name == "das2":
        return jtrace.filter_fitting(
            jtrace.gwa_like_trace("das2", 60, seed=3), 64.0)
    return jeng.Trace(**{k: jnp.asarray(v)
                         for k, v in _straggler_trace().items()})


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def get(name):
        if name not in cache:
            kw, tname = CELLS[name]
            spec, params = jeng.make_cloud(**kw)
            trace = _jax_trace(tname)
            res = jeng.simulate(spec, trace, params=params)
            flat = jflat(res)
            flat.update({f"readings.{k}": np.asarray(v)
                         for k, v in res.readings(spec).items()})
            cache[name] = (jflat(params), jflat(trace), flat)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CELLS))
def test_migrating_policy_matches_live_jax_run(name, jax_runs):
    fparams, ftrace, want = jax_runs(name)
    kw, _ = CELLS[name]
    spec = teng.CloudSpec(**{k: v for k, v in kw.items() if k in SPEC_FIELDS})
    params = teng.params_from_numpy(fparams)
    assert registry.get("pm", params.pm_sched).name == kw["pm_sched"]
    res = teng.simulate(spec, teng.trace_from_numpy(ftrace, device="cpu"),
                        params, device="cpu")
    got = teng.to_numpy(res)
    got.update({f"readings.{k}": v.numpy()
                for k, v in res.readings(spec).items()})
    _assert_matches(want, got)


def test_straggler_cells_really_migrate(jax_runs):
    """The straggler cells go through live migration in both packages: the
    reference's saved remaining work is nonzero, and the port's run equals
    it (test above)."""
    for name in ("straggler/consolidate", "straggler/defrag",
                 "straggler/evacuate"):
        _, _, want = jax_runs(name)
        assert np.abs(want["state.vm_saved_pr"]).sum() > 0, name


@pytest.fixture(scope="module")
def probe_state():
    """A JAX state mid-task (one 2-core task on a 2-PM cloud, t = 10) and
    the cloud it belongs to (tests/test_migration.py)."""
    kw = dict(n_pm=2, n_vm=16, pm_cores=4.0, net_bw=100.0, repo_bw=200.0,
              image_mb=100.0, boot_work=4.0, latency_s=0.0)
    spec, params = jeng.make_cloud(**kw)
    trace = jeng.Trace(**{k: jnp.asarray(v) for k, v in
                          _np_trace([0.0, 0.0, 0.0], [2.0, 1.0, 1.0],
                                    [50.0, 10.0, 10.0]).items()})
    res = jeng.simulate(spec, trace, params=params, t_stop=10.0)
    tspec = teng.CloudSpec(**{k: v for k, v in kw.items() if k in SPEC_FIELDS})
    return spec, params, res.state, tspec, teng.params_from_numpy(
        jflat(params))


@pytest.mark.parametrize("v, dst", [(0, 1), (1, 0), (5, 1)])
def test_start_migration_matches_jax(probe_state, v, dst):
    spec, params, st, tspec, tparams = probe_state
    want = jflat(jeng.start_migration(spec, params, st, v, dst))
    tst = teng.state_from_numpy(jflat(st), device="cpu")
    got = teng.to_numpy(teng.start_migration(tspec, tparams, tst, v, dst))
    assert set(got) == set(want)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("pm, cores, expiry", [(1, 2.0, 30.0), (0, 3.5, 12.0),
                                               (1, 9.0, 5.0)])
def test_make_allocation_matches_jax(probe_state, pm, cores, expiry):
    spec, _, st, tspec, _ = probe_state
    want_st, want_v = jeng.make_allocation(spec, st, pm, cores, expiry)
    tst = teng.state_from_numpy(jflat(st), device="cpu")
    got_st, got_v = teng.make_allocation(tspec, tst, pm, cores, expiry)
    assert int(got_v) == int(want_v)
    want, got = jflat(want_st), teng.to_numpy(got_st)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


def test_tenant_energy_matches_jax(probe_state):
    spec, params, st, tspec, tparams = probe_state
    res = jeng.simulate(spec, jeng.Trace(**{k: jnp.asarray(v) for k, v in
                                            _np_trace([0.0, 0.0, 0.0],
                                                      [2.0, 1.0, 1.0],
                                                      [20.0, 10.0, 10.0])
                                            .items()}), params=params)
    rd = {k: np.asarray(v) for k, v in res.readings(spec).items()}
    owner = np.full(spec.n_vm, -1, np.int32)
    owner[:3] = [0, 1, 1]
    owner[7] = 2
    want = np.asarray(jtenant_energy(rd, owner, 3))
    got = tenant_energy({k: torch.tensor(v) for k, v in rd.items()},
                        owner, 3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert got.shape == (3,) and (got[:2] > 0).all()


# ---------------------------------------------------------------------------
# the reference's policy invariants, on the port alone
# ---------------------------------------------------------------------------

def _cloud(pm_sched, **kw):
    base = dict(n_pm=2, n_vm=8, pm_cores=100.0, pm_sched=pm_sched)
    base.update(kw)
    return teng.make_cloud(**base)


def _run(spec, params, trace: dict, **kw):
    return teng.simulate(spec, teng.trace_from_numpy(trace, device="cpu"),
                         params, device="cpu", **kw)


def _on_one_lane(step):
    """A loop-stage function (which takes a lane axis) applied to one
    scenario's state: the state and params as the batch of one lane."""
    def run(spec, params, st, *args):
        lanes = [torch.as_tensor(a)[None] for a in args]
        return drop_lane(step(spec, teng.lane_params(params, 1, "cpu"),
                              add_lane(st), *lanes))
    return run


evacuation_step = _on_one_lane(evacuate.evacuation_step)
consolidation_step = _on_one_lane(consolidate.consolidation_step)
migrate_one = _on_one_lane(migrate.migrate_one)


def _assert_bitwise(a, b):
    fa, fb = teng.to_numpy(a), teng.to_numpy(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].tobytes() == fb[k].tobytes(), k


def test_policy_codes_keep_the_reference_order():
    assert registry.names("pm") == ("alwayson", "ondemand", "consolidate",
                                    "defrag", "evacuate")


def test_evacuation_drains_donor_in_one_pass():
    """On a two-VM donor one evacuation step plans and issues both moves
    against cumulative destination capacity; one consolidation step
    issues exactly one."""
    spec, params = _cloud("ondemand")
    st = _run(spec, params, _evac_trace(), t_stop=460.0).state
    hosted1 = (st.vstage == mc.VM_RUNNING) & (st.vm_host == 1)
    assert int(hosted1.sum()) == 2
    assert float(st.free_cores[0]) == 30.0

    st_e = evacuation_step(spec, params, st)
    moved = st_e.vstage == mc.VM_MIGRATING
    assert int(moved.sum()) == 2
    assert (st_e.vm_mig_dst[moved] == 0).all()
    assert float(st_e.free_cores[0]) == 5.0
    assert float(st_e.free_cores[1]) == 100.0

    st_c = consolidation_step(spec, params, st)
    assert int((st_c.vstage == mc.VM_MIGRATING).sum()) == 1
    # K = 1 caps the plan at one move
    st_1 = evacuation_step(dataclasses.replace(spec, max_migrations=1),
                           params, st)
    assert int((st_1.vstage == mc.VM_MIGRATING).sum()) == 1


def test_migration_writes_no_tensor_of_the_incoming_state():
    """The loop's guards compare the state before a pass with the state
    after it, so a migration must build new tensors."""
    spec, params = _cloud("ondemand")
    st = _run(spec, params, _evac_trace(), t_stop=460.0).state
    before = {k: v.copy() for k, v in teng.to_numpy(st).items()}
    after = evacuation_step(spec, params, st)
    assert int((after.vstage == mc.VM_MIGRATING).sum()) == 2
    for k, v in teng.to_numpy(st).items():
        assert v.tobytes() == before[k].tobytes(), k


def test_refused_migration_is_a_bitwise_no_op():
    """A move masked off, or of a VM that is not RUNNING, leaves every
    tensor as it was; an accepted one moves the cores."""
    spec, params = _cloud("ondemand")
    st = _run(spec, params, _evac_trace(), t_stop=460.0).state
    on1 = (st.vstage == mc.VM_RUNNING) & (st.vm_host == 1)
    v = int(torch.nonzero(on1)[0])
    free_slot = int(torch.nonzero(st.vstage == mc.VM_FREE)[0])
    for slot, ok in ((v, False), (free_slot, True)):
        out = migrate_one(spec, params, st, torch.tensor(slot),
                          torch.tensor(0), torch.tensor(ok))
        _assert_bitwise(out, st)
    out = migrate_one(spec, params, st, torch.tensor(v), torch.tensor(0),
                      torch.tensor(True))
    assert int(out.vstage[v]) == mc.VM_MIGRATING
    assert float(out.free_cores[1]) == float(st.free_cores[1] + st.vm_cores[v])
    assert float(out.free_cores[0]) == float(st.free_cores[0] - st.vm_cores[v])


def test_evacuate_completes_and_beats_ondemand():
    e = {}
    for pm in ("ondemand", "evacuate"):
        spec, params = _cloud(pm)
        r = _run(spec, params, _evac_trace())
        assert (r.state.task_state == TASK_DONE).all(), pm
        assert (r.state.pstate == PM_OFF).all(), pm
        e[pm] = float(r.readings(spec)["iaas_total"])
    assert e["evacuate"] < 0.9 * e["ondemand"], e


def test_evacuate_equals_consolidate_bitwise_on_single_vm_donor():
    trace = _np_trace([0.0, 0.01, 0.02, 230.0], [60.0, 35.0, 70.0, 25.0],
                      [2000.0, 200.0, 200.0, 2000.0])
    spec_c, params_c = _cloud("consolidate")
    spec_e, params_e = _cloud("evacuate")
    _assert_bitwise(_run(spec_c, params_c, trace),
                    _run(spec_e, params_e, trace))


@pytest.mark.parametrize("pm_sched", ["consolidate", "evacuate"])
def test_impossible_trigger_equals_ondemand_bitwise(pm_sched):
    trace = _evac_trace()
    spec, params = _cloud("ondemand")
    spec_m, params_m = _cloud(pm_sched, consolidate_idle_frac=2.0)
    _assert_bitwise(_run(spec, params, trace), _run(spec_m, params_m, trace))


def test_defrag_holds_when_nothing_can_pack():
    trace = _np_trace([0.0, 0.01, 0.02], [60.0, 50.0, 20.0],
                      [2000.0, 2000.0, 2000.0])
    spec, params = _cloud("defrag")
    mid = _run(spec, params, trace, t_stop=300.0).state
    assert not (mid.vstage == mc.VM_MIGRATING).any()
    hosts = mid.vm_host[mid.vstage == mc.VM_RUNNING]
    assert sorted(hosts.tolist()) == [0, 0, 1]
    res = _run(spec, params, trace)
    assert (res.state.task_state == TASK_DONE).all()
    assert int(res.n_events) < 100, int(res.n_events)


def test_defrag_no_churn_between_equal_hosts():
    trace = _np_trace([0.0, 0.01, 0.02], [40.0, 60.0, 40.0],
                      [1500.0, 300.0, 1500.0])
    spec, params = _cloud("defrag")
    mid = _run(spec, params, trace, t_stop=700.0).state
    assert int(mid.pstate[0]) in (PM_SWITCHING_OFF, PM_OFF)
    assert int(mid.pstate[1]) == PM_RUNNING
    assert mid.vm_host[mid.vstage == mc.VM_RUNNING].tolist() == [1, 1]
    res = _run(spec, params, trace)
    assert (res.state.task_state == TASK_DONE).all()
    assert int(res.n_events) < 120, int(res.n_events)


def test_defrag_on_single_pm_equals_ondemand_bitwise():
    trace = _np_trace([0.0, 0.01, 300.0], [40.0, 30.0, 20.0],
                      [500.0, 200.0, 400.0])
    spec_o, params_o = _cloud("ondemand", n_pm=1)
    spec_d, params_d = _cloud("defrag", n_pm=1)
    _assert_bitwise(_run(spec_o, params_o, trace),
                    _run(spec_d, params_d, trace))


def test_migration_work_conservation_via_saved_pr():
    """Suspend-transfer/resume loses no task work: the saved remaining work
    equals the flow at suspension, and completion shifts by exactly the
    memory transfer (1024 MB over the 100 MB/s NIC)."""
    spec, params = teng.make_cloud(n_pm=2, n_vm=16, pm_cores=4.0,
                                   net_bw=100.0, repo_bw=200.0,
                                   image_mb=100.0, boot_work=4.0,
                                   latency_s=0.0)
    trace = _np_trace([0.0], [2.0], [50.0])
    base = _run(spec, params, trace)
    mid = _run(spec, params, trace, t_stop=10.0)
    st = teng.start_migration(spec, params, mid.state, 0, 1)
    assert float(st.vm_saved_pr[0]) == float(mid.state.f_pr[0])
    res = _run(spec, params, trace, state=st)
    assert int(res.state.task_state[0]) == TASK_DONE
    np.testing.assert_allclose(float(res.completion[0]),
                               float(base.completion[0]) + 1024.0 / 100.0,
                               rtol=1e-4)
    cpu = slice(spec.layout.cpu0, spec.layout.cpu0 + spec.n_pm)
    np.testing.assert_allclose(float(res.state.processed[cpu].sum()),
                               float(base.state.processed[cpu].sum()),
                               rtol=1e-5)
    np.testing.assert_allclose(float(res.state.processed[cpu].sum()),
                               4.0 + 100.0, rtol=1e-4)   # boot + work
    assert (res.state.processed[cpu] > 1.0).all()


def test_eq6_reconstruction_holds_during_migration_window():
    """Mid-transfer the VM draws nothing (its meter is frozen) and the
    dependent-meter identity VM sum + unattributed == whole IaaS holds."""
    spec, params = teng.make_cloud(n_pm=2, n_vm=16, pm_cores=4.0,
                                   net_bw=100.0, repo_bw=200.0,
                                   image_mb=100.0, boot_work=4.0,
                                   latency_s=0.0)
    trace = _np_trace([0.0], [2.0], [50.0])
    mid = _run(spec, params, trace, t_stop=10.0)
    st = teng.start_migration(spec, params, mid.state, 0, 1)
    vm_at_suspend = float(mid.meters.vm.energy[0])
    for t_probe in (12.0, 16.0, 20.0):   # the transfer spans [10, 20.24]
        res = _run(spec, params, trace, state=st, t_stop=t_probe)
        rd = res.readings(spec)
        assert int(res.state.vstage[0]) == mc.VM_MIGRATING
        np.testing.assert_allclose(float(rd["vm"][0]), vm_at_suspend,
                                   rtol=1e-5)
        np.testing.assert_allclose(
            float(rd["vm"].sum()) + float(rd["vm_unattributed"]),
            float(rd["iaas_total"]), rtol=1e-5)


def test_consolidation_beats_ondemand_on_sparse_trace():
    e, idle = {}, {}
    for pm in ("alwayson", "ondemand", "consolidate"):
        spec, params = _cloud(pm)
        r = _run(spec, params, _consolidation_trace())
        assert (r.state.task_state == TASK_DONE).all(), pm
        rd = r.readings(spec)
        e[pm] = float(rd["iaas_total"])
        idle[pm] = float(rd["vm_unattributed"])
    assert e["consolidate"] < e["ondemand"] < 1.05 * e["alwayson"], e
    assert e["consolidate"] < 0.85 * e["ondemand"], e
    assert idle["consolidate"] < idle["alwayson"], idle


def test_consolidation_migrates_and_powers_donor_down():
    trace = _consolidation_trace()
    spec, params = _cloud("consolidate")
    mid = _run(spec, params, trace, t_stop=600.0).state
    d_vm = int(mid.task_vm[3])
    assert d_vm >= 0
    assert int(mid.vm_host[d_vm]) == 0
    assert int(mid.vstage[d_vm]) == mc.VM_RUNNING
    assert int(mid.pstate[1]) in (PM_SWITCHING_OFF, PM_OFF)
    spec_o, params_o = _cloud("ondemand")
    assert int(_run(spec_o, params_o, trace, t_stop=600.0).state.pstate[1]
               ) == PM_RUNNING
    res = _run(spec, params, trace)
    assert (res.state.task_state == TASK_DONE).all()
    assert (res.state.pstate == PM_OFF).all()


def test_consolidation_no_migration_churn():
    trace = _np_trace([0.0, 0.01], [60.0, 60.0], [1500.0, 1500.0])
    spec, params = _cloud("consolidate", consolidate_idle_frac=0.3)
    res = _run(spec, params, trace)
    assert (res.state.task_state == TASK_DONE).all()
    assert int(res.n_events) < 100, int(res.n_events)
    assert float(res.t_end) < 1500.0 + 2 * 1024.0 / 125.0 + 250.0


def test_tenant_energy_partitions_vm_meters():
    spec, params = teng.make_cloud(n_pm=2, n_vm=16, pm_cores=4.0)
    res = _run(spec, params, _np_trace([0.0, 0.0, 0.0], [2.0, 1.0, 1.0],
                                       [20.0, 10.0, 10.0]))
    rd = res.readings(spec)
    owner = np.full(spec.n_vm, -1, np.int32)
    owner[:3] = [0, 1, 1]
    te = tenant_energy(rd, owner, 2).numpy()
    vm = rd["vm"].numpy()
    assert te.shape == (2,) and (te > 0.0).all()
    np.testing.assert_allclose(te[0], vm[0], rtol=1e-6)
    np.testing.assert_allclose(te[1], vm[1] + vm[2], rtol=1e-6)
    np.testing.assert_allclose(te.sum(), vm.sum(), rtol=1e-6)
