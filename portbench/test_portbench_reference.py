"""The benchmark's plain reference against the port's CPU path, on tiny
clouds of each configuration, and the control (the reference in
bfloat16) against the reference: the first stays within the cells'
limits, the second does not."""
import ast
import pathlib

import numpy as np
import pytest

from portbench import check, harness, traffic
from portbench.reference import des

HERE = pathlib.Path(__file__).resolve().parent
TINY = dict(n_pm=6, n_vm=32, n_tasks=16)
GRID = {"net_bw": [62.5, 8000.0], "image_mb": [100.0, 800.0]}
CELLS = ("das2-sweep64", "lcg-sweep64")
# The engine's float32 clock can land an ulp short of a latency gate or an
# arrival, and then takes one more pass that only moves the clock by that
# ulp; a 16-task run has ~70 passes, so a few such passes weigh more than
# in the cells' runs of ~1,200 a lane, whose limit holds there.
TINY_EVENTS_GAP = 0.1


def tiny_call(cell_name, seed):
    cell = harness.load_cell(cell_name)
    config = dict(cell.config, **TINY)
    mix = dict(cell.mix, grid=GRID)
    lanes = traffic.lanes(config, mix)
    traces = traffic.call_traces(config, mix, seed, 0)
    return cell, config, lanes, traces


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("seed", [1, 2 ** 33 + 17])
def test_reference_matches_port_cpu(cell_name, seed):
    from portbench import system
    cell, config, lanes, traces = tiny_call(cell_name, seed)
    sweep = system.Sweep(config, lanes, "cpu")
    answers = sweep.answers(sweep.call(traces))
    for i, lane in enumerate(lanes):
        want = des.simulate(config, lane.point, traces[lane.trace])
        got = check.lane_numbers(check.lane_row(answers, i), want)
        assert np.isfinite(want["completion"]).all()
        limits = dict(cell.limits, events_gap=max(cell.limits["events_gap"],
                                                  TINY_EVENTS_GAP))
        assert check.verdict(got, limits), (lane.point, got)
        assert answers["n_events"][i] >= want["n_events"]


@pytest.mark.parametrize("change", ["slots_exchanged", "equal_split"])
def test_vm_meters_per_slot(change):
    """The Eq. 6 readings are held slot by slot: VMs in other slots (each
    task's slot moved with its energy) read the same, a split among the
    VMs that keeps their sum does not."""
    from portbench import system
    cell, config, lanes, traces = tiny_call("lcg-sweep64", 3)
    sweep = system.Sweep(config, lanes, "cpu")
    row = check.lane_row(sweep.answers(sweep.call(traces)), 0)
    want = des.simulate(config, lanes[0].point, traces[0])
    vm = np.asarray(row["readings"]["vm"], np.float64)
    used = np.flatnonzero(vm > 0)
    assert len(used) >= 2
    assert check.lane_numbers(row, want)["meter_gap"] < 1e-5
    if change == "slots_exchanged":
        perm = np.arange(len(vm))
        perm[used[:2]] = used[1::-1]
        vm = vm[perm]
        task_vm = np.asarray(row["task_vm"]).copy()
        placed = task_vm >= 0
        task_vm[placed] = perm[task_vm[placed]]
        row = dict(row, task_vm=task_vm)
    else:
        vm[used] = vm[used].sum() / len(used)
    row = dict(row, readings=dict(row["readings"], vm=vm))
    gap = check.lane_numbers(row, want)["meter_gap"]
    if change == "slots_exchanged":
        assert gap < 1e-5
    else:
        assert gap > cell.limits["meter_gap"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_control_in_bfloat16_fails(cell_name):
    cell, config, lanes, traces = tiny_call(cell_name, 5)
    failed = 0
    for lane in lanes:
        want = des.simulate(config, lane.point, traces[lane.trace])
        got = des.simulate(config, lane.point, traces[lane.trace],
                           precision="bfloat16",
                           max_passes=10 * want["n_events"])
        got["overflow"] = False
        failed += not check.verdict(check.lane_numbers(got, want),
                                    cell.limits)
    assert failed == len(lanes)


def test_bf16_rounding():
    assert des.bf16(1.0) == 1.0
    assert des.bf16(1.0 + 2 ** -9) == 1.0          # ties to even
    assert des.bf16(1.0 + 3 * 2 ** -9) == 1.0 + 2 ** -7
    assert des.bf16(np.inf) == np.inf
    assert des.bf16(1000.3) == 1000.0


def test_maxmin_rates_shares_a_bottleneck():
    class F:
        def __init__(self, prov, cons, limit):
            self.prov, self.cons, self.limit = prov, cons, limit

    caps = {"repo": 250.0, "a": 100.0, "b": 1000.0, "c": 1000.0}
    flows = [F("repo", "a", des.BIG), F("repo", "b", des.BIG),
             F("repo", "c", 30.0)]
    r = des.maxmin_rates(flows, caps.get, max_rounds=64, rel_eps=1e-5)
    np.testing.assert_allclose(r, [100.0, 120.0, 30.0])


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] in {"math", "numpy", "__future__"}, (
                    f"{path.name} imports {name}")


@pytest.mark.parametrize("seed", [1, 2])
def test_reference_matches_port_cpu_migrating(seed):
    """The tournament's 15 policy pairs on a tiny cloud of 4-core PMs under
    the single-core LCG-like trace, where the migrating policies move VMs
    (``consolidate`` one a pass, ``evacuate`` several, ``defrag`` toward
    the most loaded PM) and ``nonqueuing`` rejects."""
    from portbench import system
    cell = harness.load_cell("das2-tournament60")
    lcg = harness.load_cell("lcg-sweep64").config
    config = dict(lcg, **TINY, cloud=dict(lcg["cloud"], pm_cores=4.0))
    mix = dict(cell.mix, traces_per_call=1, n_tasks=TINY["n_tasks"])
    lanes = traffic.lanes(config, mix)
    traces = traffic.call_traces(config, mix, seed, 0)
    sweep = system.Sweep(config, lanes, "cpu")
    answers = sweep.answers(sweep.call(traces))
    moved = 0
    limits = dict(cell.limits, events_gap=max(cell.limits["events_gap"],
                                              TINY_EVENTS_GAP))
    for i, lane in enumerate(lanes):
        want = des.simulate(config, lane.point, traces[lane.trace])
        moved += want["migrations"]
        got = check.lane_numbers(check.lane_row(answers, i), want)
        assert check.verdict(got, limits), (lane.point, got)
    assert moved > 0
