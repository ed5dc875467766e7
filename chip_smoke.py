"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--tasks N] [--out DIR]

Phases, each of which raises on failure (nothing is caught):

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: every kernel under src/repro_torch/csrc/, one nvcc per source,
   all started together;
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes, its edge cases, its run-to-run bit identity, and its
   time (CUDA events, median of 100 launches after warm-up) beside the
   plain version's time and the bound of the work;
4. the main path at full width: 500 PM x 4096 VM under 2000 DAS-2-like
   tasks (the largest row of the repository's throughput grid), with the
   kernels' launch counters set to 0 just before and read just after;
   then a cloud above the fused solve's size gate, which runs the
   round-wise fill_stats path, counted the same way;
5. cross-check: 20 PM x 1024 VM under 200 tasks twice on the card (the two
   runs must be bit-identical) and once on the CPU (exact integers and
   event counts, floats within rtol 1e-5 / atol 1e-6); then a shorter
   full-width run under torch.profiler: device idle share, kernel launches
   and host reads per pass;
6. the last line: {"ok": true, "device": {...}}.

Exits non-zero without a result when no CUDA device is present.  Writes
the full record to DIR/chip_smoke.json (default build/chip_smoke/).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12   # f32 outside the tensor cores
RTOL, ATOL = 1e-5, 1e-6
UNCOMPARED = ("energy_lo", "t_c")   # Kahan low words: never compared


def card() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    return {"nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda}


def time_ms(fn, n: int = 100, warmup: int = 10) -> float:
    """Median device time of one call, each call between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(got, want) -> float:
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    both_inf = np.isinf(g) & np.isinf(w) & (np.sign(g) == np.sign(w))
    d = np.where(both_inf, 0.0, np.abs(g - w))
    return float(np.max(d)) if d.size else 0.0


def check_close(name, got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=name)


def flow_inputs(C: int, S: int, seed: int, dev):
    rng = np.random.RandomState(seed)
    prov = rng.randint(0, S, C).astype(np.int32)
    cons = rng.randint(0, S, C).astype(np.int32)
    p_l = (rng.rand(C) * 4 + 0.1).astype(np.float32)
    live = rng.rand(C) < 0.8
    perf = (rng.rand(S) * 10).astype(np.float32)
    r = rng.rand(C).astype(np.float32)
    unfrozen = live & (rng.rand(C) < 0.7)
    host = [torch.from_numpy(x) for x in (prov, cons, p_l, live, perf, r,
                                          unfrozen)]
    return host, [x.to(dev) for x in host]


def capture(n_pm: int, n_vm: int, n_tasks: int) -> dict:
    """Run a DAS-2-like cell on the card and keep the kernel inputs of its
    busiest pass (the most live flows): the fair-share problem, the first
    fill_stats round of it, and the horizon vector.  The recorders wrap the
    engine's call sites for this run only."""
    from repro_torch.core import engine, fairshare
    from repro_torch.core.loop import advance
    from repro_torch.core.trace import filter_fitting, gwa_like_trace

    best = {"live": -1}
    rates0, min0 = fairshare.SCHEDULERS["maxmin"], advance.masked_min

    def rates(prov, cons, p_l, live, perf, **kw):
        n = int(live.sum())
        if n > best["live"]:
            best.update(live=n, pending=True, solve=tuple(
                x.clone() for x in (prov, cons, p_l, live, perf)))
        return rates0(prov, cons, p_l, live, perf, **kw)

    def horizon(cand, mask):
        if best.pop("pending", False):
            best["horizon"] = (cand.clone(), mask.clone())
        return min0(cand, mask)

    trace = filter_fitting(gwa_like_trace("das2", n_tasks, seed=7), 64.0)
    spec, params = engine.make_cloud(n_pm=n_pm, n_vm=n_vm, pm_cores=64.0,
                                     pm_sched="ondemand",
                                     max_events=4_000_000)
    fairshare.SCHEDULERS["maxmin"], advance.masked_min = rates, horizon
    try:
        run(spec, trace, params, "cuda")
    finally:
        fairshare.SCHEDULERS["maxmin"], advance.masked_min = rates0, min0
    return best


def kernel_phase(dev, n_capture: int) -> tuple[dict, dict]:
    """Each kernel against its plain version, on random stress inputs and
    on inputs captured from the main path; timed on the captured inputs.
    Returns per-kernel records (without launch counts) and the checks."""
    from repro_torch.kernels import horizon, maxmin

    records, checks = {}, {}
    C, S = 4596, 6098                 # 500 PM x 4096 VM: F = V+P, S = 4P+2+V
    main = capture(500, 4096, n_capture)
    above = capture(1500, 8192, 30)   # S = 14194: the round-wise path
    checks["captured_live_flows"] = {"full_width": main["live"],
                                     "above_gate": above["live"]}

    def rounds_of(args):
        n = []

        def counting_fill(*a):
            n.append(1)
            return maxmin.fill_stats_plain(*a)

        out = maxmin.progressive_filling(*args, counting_fill)
        return out, len(n)

    # ---- maxmin_solve: random stress (64 rounds) and the captured pass ----
    (prov, cons, p_l, live, perf, _, _), dv = flow_inputs(C, S, 0, dev)
    cases = {"random": ((prov, cons, p_l, live, perf), dv[:5]),
             "captured": (tuple(x.cpu() for x in main["solve"]),
                          main["solve"])}
    for label, (host, dargs) in cases.items():
        got = maxmin.maxmin_solve(*dargs)
        got2 = maxmin.maxmin_solve(*dargs)
        torch.cuda.synchronize()
        want, n_rounds = rounds_of(host)
        g = got.cpu().numpy()
        check_close(f"maxmin_solve {label}", g, want.numpy())
        assert np.array_equal(g.view(np.uint32), got2.cpu().numpy().view(
            np.uint32)), f"maxmin_solve differs between two launches ({label})"
        checks[f"maxmin_solve_{label}"] = dict(
            live=int(host[3].sum()), rounds=n_rounds,
            max_abs_err=max_abs_err(g, want.numpy()),
            bit_equal_to_cpu_plain=bool(np.array_equal(
                g.view(np.uint32), want.numpy().view(np.uint32))))
    n_live, n_rounds = (checks["maxmin_solve_captured"][k]
                        for k in ("live", "rounds"))
    dargs = main["solve"]
    records["maxmin_solve"] = dict(
        shape=f"C={C} S={S} live={n_live} rounds={n_rounds} "
              f"(busiest captured pass)",
        max_abs_err=max(checks[f"maxmin_solve_{k}"]["max_abs_err"]
                        for k in cases),
        ms=time_ms(lambda: maxmin.maxmin_solve(*dargs)),
        plain_ms=time_ms(lambda: maxmin.maxmin_solve_plain(*dargs),
                         n=50, warmup=3),
        bytes=17 * C + 4 * S,
        ops=n_rounds * (4 * n_live + 8 * S + 6 * C))

    # ---- fill_stats: random at both shapes, and the captured first round
    # of the above-gate cell's busiest pass --------------------------------
    def round0(solve):
        prov, cons, _, live, perf = solve
        r = torch.zeros(prov.shape, dtype=torch.float32, device=prov.device)
        return (prov, cons, r, live, live, perf)

    fcases = {}
    for label, (c, s, seed) in (("random_main", (C, S, 1)),
                                ("random_above_gate", (9692, 14194, 2))):
        (hp, hc, _, hl, hperf, hr, hu), dv2 = flow_inputs(c, s, seed, dev)
        fcases[label] = ((hp, hc, hr, hl, hu, hperf),
                         (dv2[0], dv2[1], dv2[5], dv2[3], dv2[6], dv2[4]))
    dcap = round0(above["solve"])
    fcases["captured_above_gate"] = (tuple(x.cpu() for x in dcap), dcap)
    errs = []
    for label, (host, dargs) in fcases.items():
        dp, dc = maxmin.fill_stats(*dargs)
        dp2, dc2 = maxmin.fill_stats(*dargs)
        torch.cuda.synchronize()
        wp, wc = maxmin.fill_stats_plain(*host)
        check_close(f"fill_stats dp {label}", dp.cpu(), wp)
        check_close(f"fill_stats dc {label}", dc.cpu(), wc)
        assert torch.equal(dp, dp2) and torch.equal(dc, dc2), (
            f"fill_stats differs between two launches ({label})")
        errs.append(max(max_abs_err(dp.cpu(), wp), max_abs_err(dc.cpu(), wc)))
        checks[f"fill_stats_{label}_bit_equal_to_cpu_plain"] = bool(
            torch.equal(dp.cpu(), wp) and torch.equal(dc.cpu(), wc))
    c, s = dcap[0].shape[0], dcap[5].shape[0]
    records["fill_stats"] = dict(
        shape=f"C={c} S={s} (above-gate cell, busiest captured pass, "
              f"round 1)",
        max_abs_err=max(errs),
        ms=time_ms(lambda: maxmin.fill_stats(*dcap)),
        plain_ms=time_ms(lambda: maxmin.fill_stats_plain(*dcap)),
        bytes=14 * c + 12 * s, ops=4 * int(dcap[3].sum()) + 8 * s)

    # ---- masked_min: random, captured, and the edge cases ----------------
    N = 9696                          # 2F + P + 4 at 500 PM x 4096 VM
    rng = np.random.RandomState(3)
    cand = torch.from_numpy((rng.randn(N) * 100).astype(np.float32))
    mask = torch.from_numpy(rng.rand(N) < 0.6)
    dcand, dmask = main["horizon"]
    assert dcand.shape == (N,), dcand.shape
    edge = [("random main shape", cand, mask),
            ("captured busiest pass", dcand.cpu(), dmask.cpu())]
    for n in (1, 3, 7, 277, 1023, 1024, 1025, 2047, 2048, 2049, 5000):
        rs = np.random.RandomState(n)
        c = torch.from_numpy((rs.randn(n) * 50).astype(np.float32))
        m = torch.from_numpy(rs.rand(n) < 0.5)
        edge.append((f"random N={n}", c, m))
        edge.append((f"all masked N={n}", c, torch.zeros(n, dtype=torch.bool)))
        if n >= 1024:
            c1 = torch.full((n,), 7.5)
            c1[1023] = -3.25
            m1 = torch.zeros(n, dtype=torch.bool)
            m1[1023] = True
            edge.append((f"single survivor at lane 1023 N={n}", c1, m1))
    edge.append(("infinite unmasked lanes",
                 torch.tensor([np.inf, 3.5, np.inf, 2.0]),
                 torch.tensor([False, True, False, True])))
    edge.append(("-inf masked in", torch.tensor([1.0, -np.inf, 2.0]),
                 torch.tensor([True, True, False])))
    for label, c, m in edge:
        k = horizon.masked_min(c.to(dev), m.to(dev)).cpu().item()
        p = horizon.masked_min_plain(c, m).item()
        assert k == p, f"masked_min {label}: kernel {k} plain {p}"
    assert horizon.masked_min(torch.arange(10.).to(dev), torch.zeros(
        10, dtype=torch.bool, device=dev)).item() == float(np.float32(3e38))
    torch.cuda.synchronize()
    checks["masked_min_cases"] = len(edge) + 1
    records["masked_min"] = dict(
        shape=f"N={N} (busiest captured pass)", max_abs_err=0.0,
        ms=time_ms(lambda: horizon.masked_min(dcand, dmask)),
        plain_ms=time_ms(lambda: horizon.masked_min_plain(dcand, dmask)),
        bytes=5 * N + 4, ops=2 * N)
    return records, checks


def profile_phase(n_tasks: int) -> dict:
    """One full-width run under torch.profiler: device busy and idle share,
    kernel launches and host reads per pass, the top host-side ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import engine
    from repro_torch.core.trace import filter_fitting, gwa_like_trace

    trace = filter_fitting(gwa_like_trace("das2", n_tasks, seed=7), 64.0)
    spec, params = engine.make_cloud(n_pm=500, n_vm=4096, pm_cores=64.0,
                                     pm_sched="ondemand",
                                     max_events=4_000_000)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res, wall = run(spec, trace, params, "cuda")
    events = int(res.n_events)
    avg = prof.key_averages()
    # device rows only: a host op's self device time repeats the time of
    # the kernels it launched
    device_us = sum(e.self_device_time_total for e in avg
                    if e.device_type == DeviceType.CUDA)
    calls = {e.key: e.count for e in avg}
    launches = sum(n for k, n in calls.items() if "LaunchKernel" in k)
    reads = calls.get("aten::_local_scalar_dense", 0)
    top = sorted(avg, key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
    top_dev = sorted((e for e in avg if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total,
                     reverse=True)[:8]
    rec = dict(
        tasks=int(trace.n), events=events, wall_s=wall,
        device_busy_s=device_us / 1e6,
        device_idle_share=1.0 - device_us / 1e6 / wall,
        kernel_launches_per_pass=launches / events,
        host_reads_per_pass=reads / events,
        top_self_cpu_ms=[(e.key, e.count, e.self_cpu_time_total / 1e3)
                         for e in top],
        top_device_ms=[(e.key[:80], e.count, e.self_device_time_total / 1e3)
                       for e in top_dev])
    print(json.dumps({"profile_full_width": rec}))
    return rec


def run(spec, trace, params, device):
    from repro_torch.core import engine
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.simulate(spec, trace, params=params, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def main_path(n_tasks: int) -> dict:
    from repro_torch import kernels
    from repro_torch.core import engine
    from repro_torch.core.loop.state import TASK_DONE, TASK_REJECTED
    from repro_torch.core.trace import filter_fitting, gwa_like_trace

    out = {}
    cells = (
        ("full_width", 500, 4096, n_tasks),
        # S = 4P + 2 + V = 14194 > MAX_SOLVE_S: the round-wise path
        ("above_gate", 1500, 8192, 100),
    )
    for name, n_pm, n_vm, tasks in cells:
        trace = filter_fitting(gwa_like_trace("das2", tasks, seed=7), 64.0)
        spec, params = engine.make_cloud(
            n_pm=n_pm, n_vm=n_vm, pm_cores=64.0, pm_sched="ondemand",
            max_events=4_000_000)
        kernels.reset_launch_counts()
        res, wall = run(spec, trace, params, "cuda")
        launches = kernels.launch_counts()
        events = int(res.n_events)
        ts = res.state.task_state.cpu().numpy()
        rd = {k: float(v.sum()) for k, v in res.readings(spec).items()}
        rec = dict(n_pm=n_pm, n_vm=n_vm, tasks=int(trace.n),
                   spreaders=spec.layout.S, events=events, wall_s=wall,
                   events_per_s=events / wall, launches=launches,
                   completed=int((ts == TASK_DONE).sum()),
                   rejected=int((ts == TASK_REJECTED).sum()),
                   overflow=bool(res.overflow), t_end=float(res.t_end),
                   readings_j=rd)
        print(json.dumps({name: rec}))
        assert not rec["overflow"], f"{name}: VM slot pool overflowed"
        assert rec["completed"] + rec["rejected"] == rec["tasks"], (
            f"{name}: unfinished tasks")
        assert launches["masked_min"] == events, (
            f"{name}: masked_min launched {launches['masked_min']} times in "
            f"{events} advance passes")
        if name == "full_width":
            assert launches["maxmin_solve"] == events, launches
        else:
            assert launches["maxmin_solve"] == 0, launches
            assert launches["fill_stats"] >= events, launches
        out[name] = rec
    return out


def cross_check() -> dict:
    from repro_torch.core import engine
    from repro_torch.core.trace import filter_fitting, gwa_like_trace

    trace = filter_fitting(gwa_like_trace("das2", 200, seed=7), 64.0)
    spec, params = engine.make_cloud(n_pm=20, n_vm=1024, pm_cores=64.0,
                                     max_events=4_000_000)
    a, wall_a = run(spec, trace, params, "cuda")
    b, wall_b = run(spec, trace, params, "cuda")
    c, wall_c = run(spec, trace, params, "cpu")
    fa, fb, fc = (engine.to_numpy(x) for x in (a, b, c))
    for k in fa:
        assert fa[k].tobytes() == fb[k].tobytes(), (
            f"two card runs differ in {k}")
    for k in fa:
        if k.endswith(UNCOMPARED):
            continue
        if fa[k].dtype.kind == "f":
            np.testing.assert_allclose(fa[k], fc[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"card vs cpu: {k}")
        else:
            assert np.array_equal(fa[k].astype(np.int64),
                                  fc[k].astype(np.int64)), (
                f"card vs cpu: {k}")
    bit_equal = sum(fa[k].tobytes() == fc[k].tobytes() for k in fa)
    rec = dict(events=int(a.n_events), card_wall_s=[wall_a, wall_b],
               cpu_wall_s=wall_c, leaves=len(fa),
               leaves_bit_equal_card_cpu=bit_equal)
    print(json.dumps({"cross_check_20x1024": rec}))
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tasks", type=int, default=2000,
                    help="DAS-2-like tasks of the full-width run")
    ap.add_argument("--out", default=str(ROOT / "build" / "chip_smoke"))
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    record = {"card": card()}
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build_s = _build.build_all()
    record["build"] = dict(wall_s=time.perf_counter() - t0, per_source=build_s,
                           ptxas={n: [ln for ln in _build.build_log(n)
                                      .splitlines() if "ptxas info" in ln]
                                  for n in _build.SOURCES})
    print(json.dumps({"build": record["build"]}))

    kern, checks = kernel_phase(dev, n_capture=300)
    record["kernel_checks"] = checks
    print(json.dumps({"kernel_checks": checks}))
    record["main_path"] = main_path(args.tasks)
    record["cross_check"] = cross_check()
    record["profile"] = profile_phase(150)

    sources = {"maxmin_solve": ("src/repro_torch/csrc/maxmin.cu",
                                "src/repro/kernels/maxmin.py:201",
                                "full_width"),
               "fill_stats": ("src/repro_torch/csrc/maxmin.cu",
                              "src/repro/kernels/maxmin.py:84",
                              "above_gate"),
               "masked_min": ("src/repro_torch/csrc/horizon.cu",
                              "src/repro/kernels/horizon.py:55",
                              "full_width")}
    rows = []
    for name, (src, replaces, cell) in sources.items():
        k = kern[name]
        b_ms, b_by = bound_ms(k["bytes"], k["ops"])
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=record["main_path"][cell]["launches"][name],
            max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
            bound_ms=b_ms, bound_by=b_by, library_ms=None, shape=k["shape"],
            main_path_cell=cell))
    record["kernels"] = rows
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1))

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
