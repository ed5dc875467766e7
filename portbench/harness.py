"""One run of one cell: set-up, the timed window of sweep calls, the
traced slice (``--trace 1``), the comparison with the reference, and the
result line.

A cell is found from files alone: its entry in ``BENCHMARK.json`` names a
configuration (whose entry names its file) and a traffic mix
(``portbench/traffic/<mix>.json``); its limits are
``portbench/limits/<cell>.json`` and each per-layer metric is read by
``portbench/metrics/<metric>.py``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import pathlib
import sys
import time

import numpy as np

from . import check, traffic

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_cell(workload: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``workload`` and everything it names, from the files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; one of "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    here = root / "portbench"
    return Cell(
        name=workload, entry=entry,
        config=json.loads((root / conf["file"]).read_text()),
        mix=json.loads((here / "traffic" / f"{entry['traffic']}.json")
                       .read_text()),
        limits=json.loads((here / "limits" / f"{workload}.json")
                          .read_text())["limits"],
        end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])


def reader(metric: str, root: pathlib.Path = ROOT):
    """The ``read(ctx)`` function of ``portbench/metrics/<metric>.py``."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def process_age_s() -> float | None:
    """Seconds since this process started, from the kernel's own record
    (10 ms resolution), or None where it cannot be read."""
    try:
        stat = pathlib.Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(pathlib.Path("/proc/uptime").read_text().split()[0])
        return uptime - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def forbidden_modules(names=None) -> list[str]:
    """The top-level names among ``names`` (default: the loaded modules)
    that are JAX's or the JAX package's, each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _log(*parts):
    print("portbench:", *parts, file=sys.stderr, flush=True)


def _t_stop(traces: list[dict], n_tasks: int) -> float:
    """The stop time of a bounded call: the ``n_tasks``-th arrival of the
    call's first trace."""
    arrival = np.sort(traces[0]["arrival"])
    return float(arrival[min(n_tasks, len(arrival)) - 1])


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({e})"


@dataclasses.dataclass
class Ctx:
    """What a per-layer reader reads."""
    slice: object
    counters: dict
    device_name: str


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", root: pathlib.Path = ROOT, config_overrides=None,
        mix_overrides=None, workers: int | None = None) -> dict:
    """One run; returns the result line's object.  ``device="cpu"`` and
    the overrides serve the tests (a small cloud on the port's CPU path)."""
    t_enter = time.perf_counter()
    cell = load_cell(workload, root)
    config = dict(cell.config, **(config_overrides or {}))
    mix = dict(cell.mix, **(mix_overrides or {}))
    lanes = traffic.lanes(config, mix)
    phases = {}

    import torch
    from . import profiling, system
    phases["import_s"] = time.perf_counter() - t_enter
    on_cuda = torch.device(device).type == "cuda"
    dev_name = torch.cuda.get_device_name(0) if on_cuda else "cpu"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()

    # ---- set-up: the cell's system, one bounded warm-up call -----------
    t = time.perf_counter()
    sweep = system.Sweep(config, lanes, device)
    phases["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    warm = traffic.call_traces(config, mix, seed, -1)
    phases["traces_s"] = time.perf_counter() - t
    t = time.perf_counter()
    sweep.answers(sweep.call(warm, _t_stop(warm, mix["warmup_tasks"])))
    sweep.synchronize()
    phases["warmup_call_s"] = time.perf_counter() - t
    age = process_age_s()
    setup_s = age if age is not None else time.perf_counter() - t_enter
    phases["before_run_s"] = setup_s - (time.perf_counter() - t_enter)

    # ---- the timed window: whole calls until `seconds` have passed ------
    from torch.profiler import record_function
    calls, events, k, each = [], 0, 0, []
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        traces = traffic.call_traces(config, mix, seed, k)
        with record_function(profiling.SPAN):
            answers = sweep.answers(sweep.call(traces))
        calls.append((lanes, traces, answers))
        events += int(answers["n_events"].sum())
        each.append((int(answers["n_events"].sum()),
                     int(answers["n_events"].max()),
                     round(time.perf_counter() - t, 4)))
        k += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    _log(f"window: {k} calls, {events} lane events, {window_s:.3f} s; "
         f"calls (lane events, passes, s) {each}; set-up {setup_s:.3f} s "
         f"{json.dumps(phases)}")

    # ---- the traced slice, and its rerun with the kernels' inputs ------
    sl = counters = None
    if trace:
        sliced = traffic.call_traces(config, mix, seed, -2)
        stop = _t_stop(sliced, mix["profile_tasks"])

        def one():
            with record_function(profiling.SPAN):
                return sweep.answers(sweep.call(sliced, stop))

        t = time.perf_counter()
        got, sl = profiling.profile_call(one, sweep.synchronize)
        sl.lane_events = int(got["n_events"].sum())
        with system.KernelInputs() as rec:
            again = one()
        counters = (rec.counters() if np.array_equal(
            again["n_events"], got["n_events"]) else {})
        if not counters:
            _log("the rerun of the traced slice took other passes than "
                 "the traced run: the roofline shares are not read")
        _log(f"traced slice: {sl.lane_events} lane events, "
             f"{sl.wall_s:.3f} s, busy {sl.busy_s:.4f} s, "
             f"{sl.n_kernels} kernels, {sl.dtoh_reads} reads; read in "
             f"{time.perf_counter() - t:.1f} s; {power_limit()}")

    peak = int(torch.cuda.max_memory_allocated()) if on_cuda else 0
    del sweep
    if on_cuda:
        torch.cuda.empty_cache()

    # ---- the comparison with the reference ------------------------------
    t = time.perf_counter()
    rng = np.random.RandomState(np.random.MT19937(np.random.SeedSequence(
        [int(seed) % 2 ** 64, 7])))
    k_lanes = int(mix["check_lanes_per_call"])
    numbers, at = check.compare(
        config, calls, k_lanes, rng,
        workers=check.default_workers() if workers is None else workers)
    correct = check.verdict(numbers, cell.limits)
    _log(f"reference: {k_lanes} lanes a call in "
         f"{time.perf_counter() - t:.1f} s; each number's (call, lane): {at}")

    attempted = sum(len(c[0]) for c in calls)
    failed = sum(int(np.sum(a["overflow"] | (~np.isfinite(a["completion"])
                                             & ~a["rejected"]).any(-1)))
                 for _, _, a in calls)

    if trace:
        ctx = Ctx(slice=sl, counters=counters, device_name=dev_name)
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"], root)(ctx)
            if value is None:
                _log(f"per-layer metric {m['name']} found nothing to read "
                     "in the traced slice; it is left out of the line")
            else:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"events_per_s": events / window_s, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if on_cuda else "cpu",
                      "kind": dev_name, "count": 1,
                      "memory_peak_bytes": peak}}
    if trace:
        out["device"].update(busy_s=sl.busy_s, window_s=sl.wall_s)
        out["breakdown"] = {"device_ops": sl.device_ops,
                            "idle_gaps": sl.idle_gaps}
    out["checks"] = {n: {"value": numbers[n], "limit": cell.limits[n]}
                     for n in check.NUMBERS}
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        _log("no CUDA device: the benchmark measures the port on the card")
        return 2
    if torch.cuda.device_count() < int(cell.entry["chips"]):
        _log(f"{torch.cuda.device_count()} CUDA device(s), the cell asks "
             f"for {cell.entry['chips']}")
        return 2
    # one process drives the card; the host's work is the program's
    # enqueue, so no pool of CPU threads competes with it
    torch.set_num_threads(1)
    out = run(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        _log(f"modules of JAX or the JAX package were loaded: {bad}")
        return 3
    for n, c in out["checks"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
