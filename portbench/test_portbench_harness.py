"""The harness without a card: its result line on the port's CPU path at a
tiny size, the cell found from files alone, the byte counts of the
roofline shares, and runs with the timed path broken underneath, which
must come out not correct."""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness, profiling, roofline

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
TINY = dict(n_pm=6, n_vm=32, n_tasks=16)
MIX = dict(grid={"net_bw": [62.5, 8000.0], "image_mb": [100.0, 800.0]},
           warmup_tasks=4, profile_tasks=6, check_lanes_per_call=4)


def tiny_run(workload="das2-sweep64", trace=False, root=ROOT, seed=11):
    return harness.run(workload, seed, 0.01, trace, device="cpu", root=root,
                       config_overrides=TINY, mix_overrides=MIX, workers=1)


def check_line(out, trace):
    assert list(out)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in out
    assert isinstance(out["correct"], bool)
    dev = out["device"]
    for key in ("platform", "kind", "count", "memory_peak_bytes"):
        assert key in dev
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_result_line_schema_and_correct_on_cpu():
    out = tiny_run()
    check_line(out, trace=False)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"events_per_s", "setup_s"}
    assert out["attempted"] >= 4 and out["failed"] == 0


def test_traced_line_schema_on_cpu():
    out = tiny_run(trace=True)
    check_line(out, trace=True)
    # no device on the CPU: every per-layer reader finds nothing to read
    assert out["metrics"] == {}


def test_cell_found_from_files_alone(tmp_path):
    """A new cell, configuration, traffic mix and per-layer metric need
    only new files and entries."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    config = json.loads((HERE / "configs" / "das2-500pm-4096vm.json")
                        .read_text())
    config.update(name="das2-mini", n_pm=8)
    (tmp_path / "portbench/configs/das2-mini.json").write_text(
        json.dumps(config))
    mix = json.loads((HERE / "traffic" / "sweep64.json").read_text())
    mix.update(name="pair", grid={"net_bw": [125.0, 250.0]})
    (tmp_path / "portbench/traffic/pair.json").write_text(json.dumps(mix))
    limits = json.loads((HERE / "limits" / "das2-sweep64.json").read_text())
    (tmp_path / "portbench/limits/das2-mini-pair.json").write_text(
        json.dumps(limits))
    (tmp_path / "portbench/metrics/lane_events.py").write_text(
        "def read(ctx):\n    return float(ctx.slice.lane_events) or None\n")
    bench["configs"].append(dict(bench["configs"][0], name="das2-mini",
                                 file="portbench/configs/das2-mini.json"))
    bench["workloads"].append(dict(name="das2-mini-pair", config="das2-mini",
                                   traffic="pair", chips=1, why="a test"))
    bench["per_layer"].append(dict(
        name="lane_events", unit="events", better="higher",
        source="program_counter", layer="event loop", moves="events_per_s"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell("das2-mini-pair", tmp_path)
    assert cell.config["n_pm"] == 8 and cell.mix["name"] == "pair"
    assert [m["name"] for m in cell.per_layer][-1] == "lane_events"
    sl = profiling.Slice(wall_s=1.0, busy_s=0.5, kernels={}, kernel_s={},
                         device_ops=[], idle_gaps=[], dtoh_reads=0,
                         lane_events=42)
    assert harness.reader("lane_events", tmp_path)(
        harness.Ctx(sl, {}, "cpu")) == 42.0
    out = harness.run("das2-mini-pair", 3, 0.01, False, device="cpu",
                      root=tmp_path, config_overrides=dict(n_vm=32,
                                                           n_tasks=12),
                      mix_overrides=dict(warmup_tasks=3), workers=1)
    assert out["correct"] and out["attempted"] == 2


def test_roofline_byte_counts():
    # one lane: the live mask and the rates of every flow, each live
    # flow's three words, each touched spreader's capacity
    assert roofline.solve_bytes(4596, [12], [13]) == 5 * 4596 + 144 + 52
    assert roofline.solve_bytes(10, [1, 2], [2, 3]) == (50 + 12 + 8) + (
        50 + 24 + 12)
    assert roofline.masked_min_bytes(64, 9696) == 64 * (5 * 9696 + 4)
    assert roofline.peaks("NVIDIA H100 80GB HBM3")["bytes_per_s"] == 3.35e12
    assert roofline.peaks("cpu") is None


def test_roofline_readers_from_a_slice():
    calls_s = [dict(n_flows=100, n_live=[2, 3], n_touched=[3, 4])] * 10
    calls_m = [dict(n_lanes=2, n=50)] * 10
    sl = profiling.Slice(
        wall_s=1.0, busy_s=0.25,
        kernels={"maxmin_solve_kernel(int const*)": 10,
                 "void masked_min_kernel<float>(float const*)": 10},
        kernel_s={"maxmin_solve_kernel(int const*)": 1e-5,
                  "void masked_min_kernel<float>(float const*)": 1e-6},
        device_ops=[], idle_gaps=[], dtoh_reads=4, lane_events=2000)
    ctx = harness.Ctx(sl, dict(maxmin_solve=calls_s, masked_min=calls_m),
                      "NVIDIA H100 80GB HBM3")
    need = 10 * roofline.solve_bytes(100, [2, 3], [3, 4]) / 3.35e12
    assert harness.reader("maxmin_solve_roofline")(ctx) == pytest.approx(
        100 * need / 1e-5)
    need = 10 * roofline.masked_min_bytes(2, 50) / 3.35e12
    assert harness.reader("masked_min_roofline")(ctx) == pytest.approx(
        100 * need / 1e-6)
    assert harness.reader("device_idle_share")(ctx) == pytest.approx(75.0)
    assert harness.reader("host_reads_per_kevent")(ctx) == 2.0
    assert harness.reader("launches_per_kevent")(ctx) == 10.0
    # a rerun whose launches do not match the trace reads nothing
    ctx.counters["maxmin_solve"] = calls_s[:9]
    assert harness.reader("maxmin_solve_roofline")(ctx) is None


def test_wrapped_names_exist_in_the_port():
    """The names that the traced run wraps or patches are still where it
    looks for them, and a rerun under ``KernelInputs`` records the
    launches of both kernels and puts the port's own functions back."""
    from torch.autograd import profiler as autograd_profiler
    from repro_torch.core.loop import advance
    from repro_torch.kernels import maxmin
    from portbench import system, traffic

    assert callable(autograd_profiler.profile._parse_kineto_results)
    assert isinstance(maxmin.maxmin_solve.launches, int)
    solve0, min0 = maxmin.maxmin_solve, advance.masked_min
    cell = harness.load_cell("das2-sweep64")
    config, mix = dict(cell.config, **TINY), dict(cell.mix, **MIX)
    lanes = traffic.lanes(config, mix)
    sweep = system.Sweep(config, lanes, "cpu")
    with system.KernelInputs() as rec:
        sweep.answers(sweep.call(traffic.call_traces(config, mix, 5, 0)))
    counters = rec.counters()
    assert counters["maxmin_solve"] and counters["masked_min"]
    assert {c["n_lanes"] for c in counters["masked_min"]} == {len(lanes)}
    assert maxmin.maxmin_solve is solve0 and advance.masked_min is min0


def test_idle_gaps_labelled_by_host_op():
    device = [(0, 10, "k1"), (30, 40, "k2"), (45, 50, "Memcpy DtoH")]
    host = [(0, 100, "portbench.run_batch"), (12, 28, "aten::where"),
            (41, 44, "aten::_local_scalar_dense"),
            (41, 43, "cudaMemcpyAsync")]
    sl = profiling.reduce(device, host, wall_s=1e-7)
    assert sl.busy_s == pytest.approx(25e-9)
    assert sl.dtoh_reads == 1
    assert sl.n_kernels == 2
    assert dict((n, s) for n, s in sl.idle_gaps) == pytest.approx(
        {"aten::where": 20e-9, "aten::_local_scalar_dense": 5e-9})


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_lanes",
                                   "answer_altered"])
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    from repro_torch.core import engine
    from repro_torch.core.loop.state import _tree_map
    from repro_torch.experiments import shard

    if fault == "state_unchanged":
        # every pass returns the state it was given
        monkeypatch.setattr(engine, "_host_loop",
                            lambda spec, body, st: (st, None))
    elif fault == "half_the_lanes":
        run0 = shard.run_batch

        def half(spec, trace, params, **kw):
            res = run0(spec, trace, params, **kw)
            n = res.t_end.shape[0]
            keep = torch.arange(n) % (n // 2)    # the second half repeats
            return _tree_map(lambda t: t[keep], res)
        monkeypatch.setattr(shard, "run_batch", half)
    else:
        impl0 = engine._simulate_impl

        def altered(*args):
            res, ok = impl0(*args)
            done = torch.isfinite(res.completion)
            return res._replace(completion=torch.where(
                done, res.completion + 10.0, res.completion)), ok
        monkeypatch.setattr(engine, "_simulate_impl", altered)
    out = tiny_run()
    assert out["correct"] is False, out["checks"]


def test_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                        "das2-sweep64", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_run_without_the_port_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "das2-sweep64", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_sample_covers_every_block():
    from portbench import check
    rng = np.random.RandomState(0)
    picks = check.sample_lanes(64, 8, rng)
    assert [p // 8 for p in picks] == list(range(8))
