"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--tasks N] [--out DIR]

Phases, each of which raises on failure (nothing is caught):

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: every kernel under src/repro_torch/csrc/, one nvcc per source,
   all started together; neither the bf16 flash kernel at D = 128 nor the
   solve may spill, nor the bf16 flash kernel at D = 64 and 256 (the
   other families' head dims);
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes, its edge cases, its run-to-run bit identity, and its
   time (CUDA events, median of 100 launches after warm-up) beside the
   plain version's time and the bound of the work; maxmin_solve bit-equal
   to the CPU plain version on random, captured and every case of
   repro_torch.kernels.maxmin_cases, and so is the engine's round-wise
   route on the same inputs; maxmin_solve also timed on four cases of more
   than 32 live flows (general_cases); masked_min equal to its plain
   version on views off a 16-byte boundary, on the grid path, and on two
   grid-path calls in flight on two streams; for both, the device time
   alone (a CUDA graph of 100 calls), the wrapper's host time (a host
   clock over 1000 enqueues, median of 5) and the launch floor (an empty
   kernel through the same ctypes path, timed all three ways); the main
   path's rows at the shapes of the compacted full-width pass (C = S =
   2048, N = 4600), captured from it and held bit for bit against the CPU
   plain version, with the dense cell's shapes (C = 4596, S = 6098, N =
   9696) beside them; fill_stats also as the
   main path runs it, one round on a plan built once (its time, the plan's,
   the public call's, the wrapper's host time, and both kernels' device
   time alone from a CUDA graph), bit-equal to the CPU plain version, with
   the longest segment; then the lane axis of the three (maxmin_solve at
   B = 8 on the batched full-width cell's busiest pass and on every batch
   of maxmin_cases.lane_cases, masked_min at B = 8 x N = 9696 and on
   grid-path rows, fill_plan / fill_round at B = 2 above the gate): each
   lane bit-equal to the CPU plain version, repeat launches bit-equal,
   one launch a call, B = 1 equal to the 1-D launch; timed at B = 1 and
   B = 8 (2);
4. the main path at full width: 500 PM x 4096 VM (the largest row of the
   repository's throughput grid) under 1000 DAS-2-like tasks (--tasks;
   the grid's 2000 since slice 1, cut in slice 8 to keep the script
   inside its time limit on a slow host), compacted
   (bucket 2048, the reference's auto bucket given explicitly: full_width)
   and under the auto rule, which runs dense on the card
   (full_width_dense), on the same trace, which must agree in events,
   completions, rejections and every reading bit for bit; then a cloud
   above the fused solve's size gate, which runs the round-wise fill_stats
   path; then the migrating cell (migrating_full_width: the same cloud and
   trace under pm_sched="consolidate" at the reference's idle fraction
   0.6, max_migrations 4, bucket 2048), which must migrate at least once
   and finish every task.  Migrations are counted after each run from the
   state (the NIC-out spreaders' processed work over the VM's memory
   size, which must come to whole migrations, none in flight at the end).
   Each cell has the kernels' launch counters set to 0 just before and
   read just after, each solve's live-flow count summed on the device
   (live_flows_max and live_flows_hist, binned by the solve's code path),
   and no compaction bucket may overflow.  The migrating cell runs 1000
   tasks.  Then the batched cells through simulate_batch, counters reset
   likewise: batched_full_width (8 lanes of the full-width cell, net_bw
   x image_mb; lane (125, 100) bit-equal to full_width_dense, lane (500,
   400) to its own single run; one launch of each kernel a pass) and
   batched_above_gate (2 lanes; lane 0 bit-equal to above_gate), the
   lanes of both run as a Pareto sweep (experiments.pareto.sweep, through
   experiments.shard.run_batch; its rows and frontier recorded); then the
   streamed cells, counters reset likewise: streaming_full_width (the
   full_width_dense cloud and trace through engine.simulate_stream in
   windows of 256 tasks: events, clock, completions, rejections, overflow
   and every reading bit-equal to full_width_dense; one launch of each
   kernel a pass; window_t_end recorded) and streaming_batched (the 8
   lanes of batched_full_width through
   experiments.shard.simulate_stream_batch, its trace cut to 300 tasks:
   lane 2 bit-equal to the single stream of that trace in every leaf, one
   launch of each kernel a pass for all lanes); then batched_matrix, the
   15 (vm_sched, pm_sched) lanes at 20 PM x 1024 VM, 200 tasks, bucket
   128, as a scheduler tournament (experiments.tournament.run): two card runs
   bit-identical, one CPU run within tolerance, the firstfit lanes
   bit-equal to their single card runs, a migrating lane that migrates;
5. cross-check: 20 PM x 1024 VM under 200 tasks (bucket 128), under
   alwayson and again under evacuate (which must migrate), each twice on
   the card (the two runs must be bit-identical) and once on the CPU
   (exact integers and event counts, floats within rtol 1e-5 / atol
   1e-6); the alwayson cell again streamed in windows of 64 tasks
   (streaming_cross_check): twice on the card, bit-identical and bit-equal
   to the monolithic card run, once on the CPU within tolerance, and a
   gwa_window_stream generator of 200 tasks, card against CPU; then the
   full-width cell at 60 tasks, compacted and dense, the above-gate cell
   at 100 tasks, the batched full-width cell at 60 and the streamed
   full-width cell at 60 (in 8 windows) under torch.profiler, summarised
   from the trace's raw events: device idle share, device time of each
   hand-written kernel, events/s, kernel launches and host reads per pass
   (the compacted pass may not read the host more often than the dense
   one);
6. the standalone sharing core (core/sharing.py, core/network.py,
   core/cloud.py), each cell with the launch counters set to 0 just
   before and read just after: sharing_validation (the paper's Figs. 7-9
   through run_sharing and Fig. 10 through simulate_batch over four power
   models, against the exact single-provider solution, uncorrected <=
   corrected, 15/60/60/30 s and the analytic staircase integral within
   2%; each also on the CPU, events exact and floats within tolerance);
   sharing_fig12 (the Fig. 11/12 load at parallelism 10,000: 10,000
   single-core tasks on one spreader of 2,500 units/s with Table 1's
   power model, every completion and the energy within rtol 1e-3 of a
   float64 closed form; the solve and the power term's segment sum timed
   on the busiest pass, 10,000 live); network_full_width (1,000 nodes,
   5,000 transfers: every out-spreader's work conserved, no transfer
   faster than its narrowest rate), each of the two with a profiled
   slice of its first 1,500 passes; network_cross_check (100 nodes, 500
   transfers) and network_above_gate (6,000 nodes, S = 12,000 > 11,609,
   the round-wise route, its second card run profiled): two card runs
   bit-identical, the CPU's events exact and floats within tolerance;
   cloud_facade (the cross-check cell stopped at half its end time:
   cloud_info equal card against CPU, then deregister_pm(pm=0) and a
   resumed simulate equal card against CPU, every task done or rejected,
   the state_change_events of both steps equal);
7. LM kernels: flash_attention and linear_scan against their plain
   versions on random cases covering every feature (f32 on the CUDA-core
   kernel, bf16 on the tensor-core one, each with its own tile shape and
   visited-tile count) and at the Jamba hybrid's full-width shapes, timed
   beside the plain version, the bound and (flash) PyTorch's
   scaled_dot_product_attention, with the device time alone and the
   wrapper's host time;
8. the Jamba hybrid LM at full width, cut from 32 to 16 layers to fit in
   HBM: lm.forward over 4096 tokens (lm_forward_full_width), then a
   ServeEngine batch of 4 prompts of 384-512 tokens with 32 new tokens each
   (lm_serve_full_width), with the launch counters set to 0 just before
   and read just after; one forward and one serve batch again under
   torch.profiler (lm_profile); then the first 8 layers with attn_impl "pallas"
   against "chunked", the reference's own plain path (lm_kernel_vs_plain),
   and the reduced config in f32 on the card against the CPU
   (lm_cross_check);
9. the nine other LM architectures (lm_families: gemma2, command-r,
   codeqwen1.5, granite-3, granite-moe, phi3.5-moe, RWKV-6, seamless and
   paligemma) at their published widths in bf16, each at its published
   depth or, where the weights would not fit beside the activations, at
   the depth LM_FAMILIES gives, one after the other with the weights
   freed between: lm.forward (gemma2 at 8192 tokens, so that its window
   of 4096 masks; seamless over 1024 frames and 512 tokens; paligemma
   over 256 patches and 768 tokens) with the launch counters set to 0
   just before and read just after (one flash launch on the bf16 kernel
   per attention layer, encoder and cross layers included), every flash
   launch's visited tiles against the host's count (gemma2's local
   layers fewer than its global ones) and the first launch at each shape
   against the plain version on the same inputs; a serve of 3 prompts of
   100-500 tokens, 8 greedy tokens each (ServeEngine; lm.prefill with
   frames or patches and lm.decode_step for seamless, which ServeEngine
   refuses, and paligemma), where only the encoder and the
   cross-attention launch flash, as in the reference: those launches
   held against the plain version likewise, and every step's logits
   against attn_impl "chunked" fed the same tokens; 2 layers of each
   attention family with attn_impl "pallas" against "chunked"; each
   reduced config in f32 on the card against the CPU; then
   flash_attention at the new shapes (FAMILY_FLASH: gemma2 global and
   local at T = 8192, paligemma's prefix at D = 256, seamless's encoder
   and cross-attention at D = 64) against its plain version, timed
   beside the plain version, the bound and one PyTorch call that
   computes the same function (SDPA; for gemma2's softcap, compiled
   flex_attention);
10. LM training (train): each of the ten reduced configs in f32, two
   train steps (train.step.make_train_step) on the card against the CPU
   from one seed-0 state and the same batches, loss, grad_norm, lr and
   every parameter and moment leaf within 1e-4; granite-3-2b whole at its
   published widths (TRAIN_FULL: the seed-0 f32 train state on the card,
   bf16 compute, remat "nothing", one warm-up and three timed steps of
   B x T tokens: tokens/s, step s, peak memory; loss finite, the step
   counter at 4, the parameters moved); launch.train.main on the card on
   the reduced config with checkpoints, an injected failure (exit 42) and
   --resume, equal to an uninterrupted card run (bit for bit or within
   rtol 1e-5, recorded), its checkpoint restored on the CPU equal to the
   card's restore; the launch counters set to 0 before and read after each
   part (training launches no kernel); and flash_attention and
   linear_scan refusing card tensors that require grad;
11. the fleet (fleet): every LM architecture at decode_32k and long_500k
   through launch.dryrun on meta tensors in a pool of 8 spawned processes
   (prefill_32k and train_4k cut: minutes a cell), their records read by
   sched.energy_aware.load_cells with the H100 record, a job mix of 24 jobs
   (default_job_mix and job_trace, seed 2, arrivals over 3600 s), and
   evaluate_schedulers over the 15 (vm_sched, pm_sched) lanes on 8 nodes,
   on the card (the launch counters set to 0 just before and read just
   after: the solve and the masked min must launch) and on the CPU, the
   rows equal (integers exactly, floats within rtol 1e-5 / atol 1e-6),
   with the wall and aggregate events/s; granite-3-2b prefill at B = 1,
   T = 4096 counted by launch.op_cost on real card tensors and on meta
   tensors, product and pointwise FLOPs equal (the meta peak beside
   max_memory_allocated, recorded); the card's idle power draw;
12. the last line: {"ok": true, "device": {...}}.

Exits non-zero without a result when no CUDA device is present.  Writes
the full record to DIR/chip_smoke.json (default build/chip_smoke/).

    python3 chip_smoke.py --compare-parent DIR [--tasks N]

runs only full_width_dense, from this checkout and from the checkout
unpacked at DIR (the parent commit), each in a process of its own, in
turns parent, change, change, parent: events and readings must agree bit
for bit, host reads a pass be no more and kernel launches a pass within 5%
of the parent's; the record goes to compare_parent.json in the --out
directory.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import re
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
H100_BF16_OPS_PER_S = 989e12  # bf16 on the tensor cores, dense
RTOL, ATOL = 1e-5, 1e-6
UNCOMPARED = ("energy_lo", "t_c")   # Kahan low words: never compared


def spill_stores(report: dict, prefix: str) -> int:
    """Bytes of spill stores ptxas reports for the kernel whose mangled
    name starts with ``prefix`` (in a :func:`ptxas_report`)."""
    lines = [v for k, v in report.items() if k.startswith(prefix)]
    assert len(lines) == 1, (prefix, lines)
    return int(re.search(r"(\d+) bytes spill stores", lines[0]).group(1))


def ptxas_report(log: str) -> dict:
    """Registers, shared memory and spills of each kernel in a build log
    (``nvcc -Xptxas -v``), by mangled name."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            out[name] = ""
        elif name and ("spill" in ln or "Used" in ln):
            out[name] = (out[name] + "; " + ln.split(":", 1)[-1].strip()
                         if out[name] else ln.split(":", 1)[-1].strip())
    return out


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


def host_us(fn, n: int = 1000, reps: int = 5) -> float:
    """Host time of one call in microseconds: a host clock over ``n`` calls
    that enqueue work with no synchronisation in between, the median of
    ``reps`` such runs (the host is shared, and its clock spreads)."""
    for _ in range(10):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def graph_ms(fn, n: int = 100) -> float:
    """Device time of one call without the host's launch work: ``n`` calls
    captured in one CUDA graph, the replay timed between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = H100_F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
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


def capture(n_pm: int, n_vm: int, n_tasks: int, compact: int = -1,
            lanes: dict | None = None, device: str = "cuda") -> dict:
    """Run a DAS-2-like cell on the card and keep the kernel inputs of its
    busiest pass (the most live flows, over all lanes): the fair-share
    problem, the first fill_stats round of it, and the horizon vector.
    ``compact`` is the spec's compaction setting (0 dense, > 0 a bucket;
    auto runs dense on the card).  ``lanes`` runs a batch (``{param:
    [value a lane]}``) and keeps every lane's row ([B, ...]); without it
    the one scenario's row ([C], [S], [N]).  The recorders wrap the
    engine's call sites for this run only."""
    from repro_torch.core import engine, fairshare
    from repro_torch.core.loop import advance
    from repro_torch.core.trace import filter_fitting, gwa_like_trace

    best = {"live": -1}
    rates0, min0 = fairshare.SCHEDULERS["maxmin"], advance.masked_min
    row = (lambda x: x.clone()) if lanes else (lambda x: x[0].clone())

    def rates(prov, cons, p_l, live, perf, **kw):
        n = int(live.sum())
        if n > best["live"]:
            best.update(live=n, pending=True, solve=tuple(
                row(x) for x in (prov, cons, p_l, live, perf)))
        return rates0(prov, cons, p_l, live, perf, **kw)

    def horizon(cand, mask):
        if best.pop("pending", False):
            best["horizon"] = (row(cand), row(mask))
        return min0(cand, mask)

    trace = filter_fitting(gwa_like_trace("das2", n_tasks, seed=7), 64.0)
    spec, params = engine.make_cloud(n_pm=n_pm, n_vm=n_vm, pm_cores=64.0,
                                     pm_sched="ondemand", compact=compact,
                                     max_events=4_000_000)
    fairshare.SCHEDULERS["maxmin"], advance.masked_min = rates, horizon
    try:
        if lanes:
            run_batch(spec, trace, sweep_params(params, lanes), device)
        else:
            run(spec, trace, params, device)
    finally:
        fairshare.SCHEDULERS["maxmin"], advance.masked_min = rates0, min0
    return best


def launch_floor(dev) -> dict:
    """An empty kernel launched through the ``ctypes`` path of masked_min
    (same marshalling, the stream read the same way), timed as the kernels
    are: between CUDA events, alone from a CUDA graph, and on the host."""
    from repro_torch.kernels import horizon
    from repro_torch.kernels.maxmin import _stream

    fn = horizon._lib().empty_launch
    x = torch.empty(16, device=dev)
    ptr = x.data_ptr()

    def call():
        assert fn(ptr, ptr, ptr, None, 16, 1, _stream(dev)) == 0

    return dict(launch_floor_ms=time_ms(call),
                launch_floor_device_ms=graph_ms(call),
                launch_floor_host_us=host_us(call))


def kernel_phase(dev, n_capture: int) -> tuple[dict, dict]:
    """Each kernel against its plain version, on random stress inputs and
    on inputs captured from the main path; timed on the captured inputs.
    Returns per-kernel records (without launch counts) and the checks."""
    from repro_torch.kernels import horizon, maxmin
    from repro_torch.kernels.maxmin_cases import solve_cases

    records, checks = {}, {}
    C, S = 4596, 6098                 # 500 PM x 4096 VM: F = V+P, S = 4P+2+V
    FB = 2048                         # its compaction bucket, next_pow2(4P+32)
    main = capture(500, 4096, n_capture, compact=0)
    comp = capture(500, 4096, n_capture, compact=FB)  # compacted
    above = capture(1500, 8192, 30)   # S = 14194: the round-wise path
    assert [x.shape[0] for x in main["solve"]] == [C] * 4 + [S]
    assert [x.shape[0] for x in comp["solve"]] == [FB] * 5
    checks["captured_live_flows"] = {"full_width_dense": main["live"],
                                     "full_width": comp["live"],
                                     "above_gate": above["live"]}

    def rounds_of(args, max_iters=64):
        n = []

        def counting_round(*a):
            n.append(1)
            return maxmin.fill_round_plain(*a)

        out = maxmin.progressive_filling(*args, counting_round,
                                         plan_fn=maxmin.fill_plan_plain,
                                         max_iters=max_iters)
        return out, len(n)

    # ---- maxmin_solve: random stress (64 rounds), the captured pass and
    # every edge case, each bit-equal to the CPU plain version ------------
    (prov, cons, p_l, live, perf, _, _), dv = flow_inputs(C, S, 0, dev)
    cases = {"random": ((prov, cons, p_l, live, perf), dv[:5], 64),
             "captured": (tuple(x.cpu() for x in main["solve"]),
                          main["solve"], 64),
             "captured_compacted": (tuple(x.cpu() for x in comp["solve"]),
                                    comp["solve"], 64)}
    for case in solve_cases():
        host = tuple(torch.from_numpy(x) for x in case.args())
        cases[case.label] = (host, tuple(x.to(dev) for x in host),
                             case.max_iters)
    for label, (host, dargs, iters) in cases.items():
        got = maxmin.maxmin_solve(*dargs, max_iters=iters)
        got2 = maxmin.maxmin_solve(*dargs, max_iters=iters)
        torch.cuda.synchronize()
        want, n_rounds = rounds_of(host, iters)
        g, w = got.cpu().numpy(), want.numpy()
        assert np.array_equal(g.view(np.uint32), w.view(np.uint32)), (
            f"maxmin_solve {label}: not bit-equal to the CPU plain version "
            f"(max abs err {max_abs_err(g, w)})")
        assert np.array_equal(g.view(np.uint32), got2.cpu().numpy().view(
            np.uint32)), f"maxmin_solve differs between two launches ({label})"
        # the engine's other route (a plan, then a round at a time) on the
        # same inputs: the two routes of maxmin_rates agree bit for bit
        wise = maxmin.progressive_filling(*dargs, maxmin.fill_round,
                                          max_iters=iters).cpu().numpy()
        assert np.array_equal(wise.view(np.uint32), w.view(np.uint32)), (
            f"maxmin_solve {label}: the round-wise route is not bit-equal "
            f"to the CPU plain version (max abs err {max_abs_err(wise, w)})")
        checks[f"maxmin_solve_{label}"] = dict(
            live=int(host[3].sum()), rounds=n_rounds, max_iters=iters,
            max_abs_err=max_abs_err(g, w), bit_equal_to_cpu_plain=True,
            round_wise_bit_equal=True)
    floor = launch_floor(dev)

    def solve_timing(label):
        """Times and the bound of the solve on a captured pass: the bound
        counts what these inputs need (live read, r written, each live
        flow's provider, consumer and p_l, each touched spreader's perf)."""
        n_live, n_rounds = (checks[f"maxmin_solve_{label}"][k]
                            for k in ("live", "rounds"))
        dargs = cases[label][1]
        hp, hc, _, hl, _ = (x.cpu() for x in dargs)
        c, s = dargs[0].shape[0], dargs[4].shape[0]
        touched = int(torch.unique(torch.cat([hp[hl], hc[hl]])).numel())
        runs = int(torch.unique(hp[hl]).numel()
                   + torch.unique(hc[hl]).numel())
        return dict(
            shape=f"C={c} S={s} live={n_live} rounds={n_rounds} touched "
                  f"spreaders={touched} (busiest captured pass)",
            ms=time_ms(lambda: maxmin.maxmin_solve(*dargs)),
            device_ms=graph_ms(lambda: maxmin.maxmin_solve(*dargs)),
            host_us=host_us(lambda: maxmin.maxmin_solve(*dargs)),
            plain_ms=time_ms(lambda: maxmin.maxmin_solve_plain(*dargs),
                             n=50, warmup=3),
            bytes=c + 4 * c + 12 * n_live + 4 * touched,
            ops=n_rounds * (10 * n_live + 3 * runs))

    # the general side of the solve (block sort, named barriers, the global
    # workspace), timed on cases with more than 32 live flows
    general = {}
    for label in ("random", "smem_capacity", "one_provider",
                  "all_64_rounds"):
        _, gargs, iters = cases[label]

        def call(gargs=gargs, iters=iters):
            return maxmin.maxmin_solve(*gargs, max_iters=iters)

        general[label] = dict(
            live=checks[f"maxmin_solve_{label}"]["live"],
            rounds=checks[f"maxmin_solve_{label}"]["rounds"],
            ms=time_ms(call, n=20, warmup=3), device_ms=graph_ms(call, n=20))
    # the main path's shapes are the compacted ones; the dense cell's
    # shapes are kept beside them
    records["maxmin_solve"] = dict(
        solve_timing("captured_compacted"),
        max_abs_err=max(checks[f"maxmin_solve_{k}"]["max_abs_err"]
                        for k in cases),
        dense=solve_timing("captured"), general_cases=general, **floor)

    # ---- fill_stats: random at both shapes, and the captured first round
    # of the above-gate cell's busiest pass; the public call (plan from
    # live | unfrozen, then one round) and a round on the main path's plan
    # (from live) must both equal the CPU plain version bit for bit ------
    def round0(solve):
        prov, cons, _, live, perf = solve
        r = torch.zeros(prov.shape, dtype=torch.float32, device=prov.device)
        return (prov, cons, r, live, live, perf)

    fcases = {}
    for label, (c, s, seed) in (
            ("random_main", (C, S, 1)),
            ("random_above_gate", (9692, 14194, 2)),
            # above MAX_PLAN_SMEM_S: the plan's counts in global scratch
            ("random_large_s", (20000, maxmin.MAX_PLAN_SMEM_S + 5000, 3))):
        (hp, hc, _, hl, hperf, hr, hu), dv2 = flow_inputs(c, s, seed, dev)
        fcases[label] = ((hp, hc, hr, hl, hu, hperf),
                         (dv2[0], dv2[1], dv2[5], dv2[3], dv2[6], dv2[4]))
    dcap = round0(above["solve"])
    fcases["captured_above_gate"] = (tuple(x.cpu() for x in dcap), dcap)
    errs = []
    for label, (host, dargs) in fcases.items():
        dp, dc = maxmin.fill_stats(*dargs)
        dp2, dc2 = maxmin.fill_stats(*dargs)
        prov, cons, r, live, unfrozen, perf = dargs
        plan = maxmin.fill_plan(prov, cons, live, None, perf.shape[0])
        rp, rc = maxmin.fill_round(plan, r, live, unfrozen & live, perf)
        torch.cuda.synchronize()
        wp, wc = maxmin.fill_stats_plain(*host)
        hp, hc = maxmin.fill_stats_plain(*host[:4], host[4] & host[3],
                                         host[5])
        check_close(f"fill_stats dp {label}", dp.cpu(), wp)
        check_close(f"fill_stats dc {label}", dc.cpu(), wc)
        assert torch.equal(dp, dp2) and torch.equal(dc, dc2), (
            f"fill_stats differs between two launches ({label})")
        for got, want, what in ((dp, wp, "dp"), (dc, wc, "dc"),
                                (rp, hp, "dp on a live plan"),
                                (rc, hc, "dc on a live plan")):
            assert torch.equal(got.cpu(), want), (
                f"fill_stats {what} ({label}): not bit-equal to the CPU "
                f"plain version")
        errs.append(max(max_abs_err(dp.cpu(), wp), max_abs_err(dc.cpu(), wc)))
        checks[f"fill_stats_{label}_bit_equal_to_cpu_plain"] = True
    c, s = dcap[0].shape[0], dcap[5].shape[0]
    # the main path's plan: built once per solve from live
    plan = maxmin.fill_plan(dcap[0], dcap[1], dcap[3], None, s)
    records["fill_stats"] = dict(
        shape=f"C={c} S={s} (above-gate cell, busiest captured pass, "
              f"round 1, on its plan)",
        max_abs_err=max(errs),
        ms=time_ms(lambda: maxmin.fill_round(plan, *dcap[2:])),
        plan_ms=time_ms(lambda: maxmin.fill_plan(dcap[0], dcap[1], dcap[3],
                                                 None, s)),
        public_ms=time_ms(lambda: maxmin.fill_stats(*dcap)),
        # device time alone (the events above also hold the wrapper's host
        # work, which is longer than these launch-bound kernels)
        graph_ms=graph_ms(lambda: maxmin.fill_round(plan, *dcap[2:])),
        plan_graph_ms=graph_ms(lambda: maxmin.fill_plan(
            dcap[0], dcap[1], dcap[3], None, s)),
        host_us=host_us(lambda: maxmin.fill_round(plan, *dcap[2:])),
        plain_ms=time_ms(lambda: maxmin.fill_stats_plain(*dcap)),
        longest_segment=plan.longest_segment(),
        plan_flows=int(plan.off_p[-1]),
        bytes=14 * c + 12 * s, ops=4 * int(dcap[3].sum()) + 8 * s)

    # ---- masked_min: random, captured, and the edge cases ----------------
    N = 9696                          # 2F + P + 4 at 500 PM x 4096 VM
    rng = np.random.RandomState(3)
    cand = torch.from_numpy((rng.randn(N) * 100).astype(np.float32))
    mask = torch.from_numpy(rng.rand(N) < 0.6)
    dcand, dmask = main["horizon"]
    ccand, cmask = comp["horizon"]
    NB = 2 * FB + 500 + 4             # the compacted pass's horizon vector
    assert dcand.shape == (N,), dcand.shape
    assert ccand.shape == (NB,), ccand.shape
    edge = [("random main shape", cand, mask),
            ("captured busiest pass", dcand.cpu(), dmask.cpu()),
            ("captured compacted pass", ccand.cpu(), cmask.cpu())]
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
    edge.append(("NaN masked in", torch.tensor([1.0, np.nan, -2.0]),
                 torch.tensor([True, True, True])))
    # the grid path (several blocks and the last block's reduction)
    for n in (65537, 200_000):
        rs = np.random.RandomState(n)
        c = torch.from_numpy((rs.randn(n) * 50).astype(np.float32))
        m = torch.from_numpy(rs.rand(n) < 0.5)
        edge.append((f"grid path random N={n}", c, m))
        edge.append((f"grid path all masked N={n}", c,
                     torch.zeros(n, dtype=torch.bool)))
        m1 = torch.zeros(n, dtype=torch.bool)
        m1[-1] = True
        edge.append((f"grid path survivor at the last lane N={n}", c, m1))
    for label, c, m in edge:
        k = horizon.masked_min(c.to(dev), m.to(dev)).cpu().item()
        p = horizon.masked_min_plain(c, m).item()
        assert k == p or (np.isnan(k) and np.isnan(p)), (
            f"masked_min {label}: kernel {k} plain {p}")
    # views that start off a 16-byte boundary: cand and mask aligned
    # together (scalar head, vector body, scalar tail), and apart (all
    # scalar)
    dc_base = torch.from_numpy((rng.randn(N + 8) * 100).astype(
        np.float32)).to(dev)
    dm_base = torch.from_numpy(rng.rand(N + 16) < 0.6).to(dev)
    views = {"cand and mask one lane in": (1, 1),
             "cand one lane in, mask aligned": (1, 0),
             "cand 3 and mask 7 lanes in": (3, 7)}
    for label, (co, mo) in views.items():
        c, m = dc_base[co:co + N], dm_base[mo:mo + N]
        k = horizon.masked_min(c, m).cpu().item()
        p = horizon.masked_min_plain(c.cpu(), m.cpu()).item()
        assert k == p, f"masked_min view {label}: kernel {k} plain {p}"
    # two grid-path calls in flight at once on two streams: each counts on
    # a ticket of its own, so each equals its plain version
    pair = []
    for n, seed in ((200_000, 11), (131_072, 12)):
        rs = np.random.RandomState(seed)
        pair.append((torch.from_numpy((rs.randn(n) * 50).astype(np.float32)),
                     torch.from_numpy(rs.rand(n) < 0.5)))
    for _ in range(10):
        streams = [torch.cuda.Stream() for _ in pair]
        ins = [(c.to(dev), m.to(dev)) for c, m in pair]
        outs = []
        for st, (c, m) in zip(streams, ins):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                outs.append(horizon.masked_min(c, m))
        torch.cuda.synchronize()
        for (c, m), got in zip(pair, outs):
            k, p = got.item(), horizon.masked_min_plain(c, m).item()
            assert k == p, f"masked_min on two streams: kernel {k} plain {p}"
    assert horizon.masked_min(torch.arange(10.).to(dev), torch.zeros(
        10, dtype=torch.bool, device=dev)).item() == float(np.float32(3e38))
    try:
        horizon.masked_min(torch.zeros(0, device=dev),
                           torch.zeros(0, dtype=torch.bool, device=dev))
    except ValueError:
        pass
    else:
        raise AssertionError("masked_min accepted an empty vector")
    torch.cuda.synchronize()
    checks["masked_min_cases"] = len(edge) + len(views) + len(pair) + 2

    def min_timing(c, m):
        n = c.shape[0]
        return dict(
            shape=f"N={n} (busiest captured pass)",
            ms=time_ms(lambda: horizon.masked_min(c, m)),
            device_ms=graph_ms(lambda: horizon.masked_min(c, m)),
            host_us=host_us(lambda: horizon.masked_min(c, m)),
            plain_ms=time_ms(lambda: horizon.masked_min_plain(c, m)),
            bytes=5 * n + 4, ops=2 * n)

    records["masked_min"] = dict(min_timing(ccand, cmask), max_abs_err=0.0,
                                 dense=min_timing(dcand, dmask), **floor)
    return records, checks


# the batched full-width cell's lanes: net_bw x image_mb, a Pareto-style
# grid; lane 2 (125 MB/s, 100 MB) is the full_width_dense scenario
FULL_WIDTH_SWEEP = {"net_bw": [62.5, 62.5, 125.0, 125.0, 250.0, 250.0,
                               500.0, 500.0],
                    "image_mb": [100.0, 400.0] * 4}
ABOVE_GATE_SWEEP = {"net_bw": [125.0, 250.0]}


def _bit_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def _solve_work(dargs, iters) -> tuple[int, int, list]:
    """Bytes and operations a batch of solves needs, summed over its lanes
    (each lane: live read, r written, each live flow's provider, consumer
    and p_l, each touched spreader's perf; per round 10 operations a live
    flow and 3 a run), and each lane's live count and rounds, counted on
    the CPU plain version."""
    from repro_torch.kernels import maxmin
    n_bytes = n_ops = 0
    per_lane = []
    for lane in zip(*(x.cpu() for x in dargs)):
        hp, hc, _, hl, _ = lane
        c = hp.shape[0]
        n_live = int(hl.sum())
        touched = int(torch.unique(torch.cat([hp[hl], hc[hl]])).numel())
        runs = int(torch.unique(hp[hl]).numel() + torch.unique(hc[hl]).numel())
        rounds = []
        maxmin.progressive_filling(
            *lane, lambda *a: rounds.append(1) or maxmin.fill_round_plain(*a),
            plan_fn=maxmin.fill_plan_plain, max_iters=iters)
        n_bytes += c + 4 * c + 12 * n_live + 4 * touched
        n_ops += len(rounds) * (10 * n_live + 3 * runs)
        per_lane.append((n_live, len(rounds)))
    return n_bytes, n_ops, per_lane


def lane_kernel_phase(dev, n_capture: int) -> tuple[dict, dict]:
    """The lane axis of the three main-path kernels on the card: maxmin_solve
    at B = 8 on the busiest pass of the batched full-width cell (captured
    from a run of ``n_capture`` tasks) and on every batch of
    ``maxmin_cases.lane_cases``; masked_min at B = 8 x N = 9696 (captured
    and random) and on grid-path rows (N > 65,536); fill_plan / fill_round
    at B = 2 on the batched above-gate cell's busiest pass and at random.
    Each launch must equal the CPU plain version on every row bit for bit,
    repeat bit for bit, count one launch whatever B is, and at B = 1 equal
    the 1-D launch.  Timed at B = 1 and at B = 8 (B = 2 for the round)."""
    from repro_torch.kernels import horizon, maxmin
    from repro_torch.kernels.maxmin_cases import lane_cases

    records, checks = {}, {}
    cap = capture(500, 4096, n_capture, compact=0, lanes=FULL_WIDTH_SWEEP)
    above = capture(1500, 8192, 30, lanes=ABOVE_GATE_SWEEP)
    B = len(FULL_WIDTH_SWEEP["net_bw"])
    assert [tuple(x.shape) for x in cap["solve"]] == [(B, 4596)] * 4 + [
        (B, 6098)], [x.shape for x in cap["solve"]]

    def one_launch(wrapper, fn):
        n0 = wrapper.launches
        out = fn()
        assert wrapper.launches == n0 + 1, (
            f"{wrapper.__name__}: a lane-axis call must be one launch")
        return out

    # ---- maxmin_solve --------------------------------------------------
    sets = {"captured_batched_full_width": (cap["solve"], 64)}
    for case in lane_cases():
        sets[case.label] = (tuple(torch.from_numpy(x).to(dev)
                                  for x in case.args()), case.max_iters)
    for label, (dargs, iters) in sets.items():
        got = one_launch(maxmin.maxmin_solve,
                         lambda: maxmin.maxmin_solve(*dargs, max_iters=iters))
        got2 = maxmin.maxmin_solve(*dargs, max_iters=iters)
        b1 = maxmin.maxmin_solve(*(x[:1] for x in dargs), max_iters=iters)
        d1 = maxmin.maxmin_solve(*(x[0] for x in dargs), max_iters=iters)
        wise = maxmin.progressive_filling(*dargs, maxmin.fill_round,
                                          max_iters=iters)
        torch.cuda.synchronize()
        want = maxmin.maxmin_solve_plain(*(x.cpu() for x in dargs),
                                         max_iters=iters)
        g = got.cpu()
        for b in range(g.shape[0]):
            assert _bit_equal(g[b], want[b]), (
                f"maxmin_solve lanes {label}: lane {b} not bit-equal to the "
                f"CPU plain version (max abs err "
                f"{max_abs_err(g[b], want[b])})")
        assert _bit_equal(g, got2.cpu()), f"maxmin_solve lanes {label}: repeat"
        assert _bit_equal(b1.cpu()[0], d1.cpu()) and _bit_equal(
            d1.cpu(), g[0]), f"maxmin_solve lanes {label}: B = 1 vs 1-D"
        assert _bit_equal(wise.cpu(), g), (
            f"maxmin_solve lanes {label}: the round-wise route differs")
        checks[f"maxmin_solve_lanes_{label}"] = dict(
            lanes=g.shape[0], bit_equal_to_cpu_plain=True)

    def timing(fn, plain, n_bytes, n_ops, n_plain=20):
        return dict(ms=time_ms(fn), device_ms=graph_ms(fn),
                    host_us=host_us(fn),
                    plain_ms=time_ms(plain, n=n_plain, warmup=2),
                    bytes=n_bytes, ops=n_ops)

    dargs = cap["solve"]
    dargs1 = tuple(x[:1] for x in dargs)      # B = 1: the first lane
    nb8, no8, per_lane = _solve_work(dargs, 64)
    nb1, no1, _ = _solve_work(dargs1, 64)
    b8 = timing(lambda: maxmin.maxmin_solve(*dargs),
                lambda: maxmin.maxmin_solve_plain(*dargs), nb8, no8)
    b1 = timing(lambda: maxmin.maxmin_solve(*dargs1),
                lambda: maxmin.maxmin_solve_plain(*dargs1), nb1, no1)
    records["maxmin_solve_lanes"] = dict(
        b8, shape=f"B={B} x (C=4596, S=6098), (live, rounds) a lane "
                  f"{per_lane} (batched full width, busiest captured pass)",
        max_abs_err=0.0, b1=b1)

    # ---- masked_min ----------------------------------------------------
    rng = np.random.RandomState(5)
    N = 9696
    ccand, cmask = cap["horizon"]
    assert tuple(ccand.shape) == (B, N), ccand.shape
    rows = {"captured_batched_full_width": (ccand, cmask),
            "random": (torch.from_numpy((rng.randn(B, N) * 100).astype(
                np.float32)).to(dev), torch.from_numpy(rng.rand(B, N) < 0.6)
                .to(dev)),
            "grid_path_rows": (torch.from_numpy((rng.randn(3, 70_000) * 50)
                                                .astype(np.float32)).to(dev),
                               torch.from_numpy(rng.rand(3, 70_000) < 0.5)
                               .to(dev))}
    edge_c, edge_m = (x.clone() for x in rows["random"])
    edge_m[1] = False                               # an empty row: 3e38
    edge_c[2, 7], edge_m[2, 7] = float("nan"), True  # a NaN row
    rows["empty_and_nan_rows"] = (edge_c, edge_m)
    for label, (c, m) in rows.items():
        got = one_launch(horizon.masked_min,
                         lambda: horizon.masked_min(c, m))
        got2 = horizon.masked_min(c, m)
        b1 = horizon.masked_min(c[:1], m[:1])
        d1 = horizon.masked_min(c[0], m[0])
        torch.cuda.synchronize()
        want = horizon.masked_min_plain(c.cpu(), m.cpu())
        g = got.cpu()
        for b in range(g.shape[0]):
            k, p = g[b].item(), want[b].item()
            assert k == p or (np.isnan(k) and np.isnan(p)), (
                f"masked_min rows {label}: row {b} kernel {k} plain {p}")
        assert _bit_equal(g, got2.cpu()) and _bit_equal(
            b1.cpu()[0], d1.cpu()) and _bit_equal(d1.cpu(), g[0]), (
            f"masked_min rows {label}: repeat or B = 1 vs 1-D")
        checks[f"masked_min_rows_{label}"] = dict(rows=g.shape[0],
                                                   equal_to_cpu_plain=True)
    c1, m1 = ccand[:1], cmask[:1]
    records["masked_min_lanes"] = dict(
        timing(lambda: horizon.masked_min(ccand, cmask),
               lambda: horizon.masked_min_plain(ccand, cmask),
               B * (5 * N + 4), B * 2 * N, n_plain=50),
        shape=f"B={B} x N={N} (batched full width, busiest captured pass)",
        max_abs_err=0.0,
        b1=timing(lambda: horizon.masked_min(c1, m1),
                  lambda: horizon.masked_min_plain(c1, m1),
                  5 * N + 4, 2 * N, n_plain=50))

    # ---- fill_plan / fill_round ----------------------------------------
    prov, cons, _, live, perf = above["solve"]
    L2 = prov.shape[0]
    S2 = perf.shape[-1]
    r0 = torch.zeros(prov.shape, dtype=torch.float32, device=dev)
    fsets = {"captured_batched_above_gate": (prov, cons, r0, live, live,
                                             perf)}
    lanes = [flow_inputs(prov.shape[1], S2, seed, dev)[1] for seed in (7, 8)]
    fsets["random_above_gate"] = tuple(
        torch.stack([ln[i] for ln in lanes]) for i in (0, 1, 5, 3, 6, 4))
    for label, fargs in fsets.items():
        fp, fc, fr, fl, fu, fperf = fargs
        n_plan, n_round = maxmin.fill_plan.launches, maxmin.fill_stats.launches
        plan = maxmin.fill_plan(fp, fc, fl, None, S2)
        dp, dc = maxmin.fill_round(plan, fr, fl, fu & fl, fperf)
        assert (maxmin.fill_plan.launches, maxmin.fill_stats.launches) == (
            n_plan + 1, n_round + 1), "fill_plan / fill_round: one launch"
        pp, pc = maxmin.fill_stats(*fargs)
        dp2, dc2 = maxmin.fill_round(plan, fr, fl, fu & fl, fperf)
        one = maxmin.fill_round(maxmin.fill_plan(fp[:1], fc[:1], fl[:1], None,
                                                 S2), fr[:1], fl[:1],
                                (fu & fl)[:1], fperf[:1])
        vec = maxmin.fill_round(maxmin.fill_plan(fp[0], fc[0], fl[0], None,
                                                 S2), fr[0], fl[0],
                                (fu & fl)[0], fperf[0])
        torch.cuda.synchronize()
        host = tuple(x.cpu() for x in fargs)
        wp, wc = maxmin.fill_stats_plain(*host[:4], host[4] & host[3],
                                         host[5])
        xp, xc = maxmin.fill_stats_plain(*host)
        wplan = maxmin.fill_plan_plain(host[0], host[1], host[3], None, S2)
        # the offsets whole, each lane's CSR up to its end (the tail is
        # unused: the kernel leaves it unwritten)
        for got, want, off in zip(plan, wplan, (wplan.off_p, wplan.off_p,
                                                wplan.off_c, wplan.off_c)):
            got = got.cpu()
            for b in range(L2):
                n = want.shape[-1] if want.shape[-1] == S2 + 1 else int(
                    off[b, -1])
                assert torch.equal(got[b, :n], want[b, :n]), (
                    f"fill_plan lanes {label}: lane {b}")
        for got, want in ((dp, wp), (dc, wc), (pp, xp), (pc, xc),
                          (dp2, wp), (dc2, wc)):
            assert _bit_equal(got.cpu(), want), (
                f"fill_round lanes {label}: not bit-equal to the CPU plain "
                f"version")
        for a, b in zip(one, vec):
            assert _bit_equal(a.cpu()[0], b.cpu()), f"fill lanes {label} B=1"
        assert _bit_equal(vec[0].cpu(), wp[0]), f"fill lanes {label} 1-D"
        checks[f"fill_lanes_{label}"] = dict(lanes=L2,
                                             bit_equal_to_cpu_plain=True)
    plan2 = maxmin.fill_plan(prov, cons, live, None, S2)
    p1, c1, l1, f1, r1 = prov[:1], cons[:1], live[:1], perf[:1], r0[:1]
    plan1 = maxmin.fill_plan(p1, c1, l1, None, S2)
    C2 = prov.shape[1]
    n_live = int(live.sum())
    records["fill_stats_lanes"] = dict(
        timing(lambda: maxmin.fill_round(plan2, r0, live, live, perf),
               lambda: maxmin.fill_round_plain(plan2, r0, live, live, perf),
               L2 * (14 * C2 + 12 * S2), 4 * n_live + L2 * 8 * S2),
        plan_ms=time_ms(lambda: maxmin.fill_plan(prov, cons, live, None, S2)),
        plan_device_ms=graph_ms(lambda: maxmin.fill_plan(prov, cons, live,
                                                         None, S2)),
        shape=f"B={L2} x (C={C2}, S={S2}), a round on its plan (batched "
              f"above-gate cell, busiest captured pass)",
        longest_segment=plan2.longest_segment(), max_abs_err=0.0,
        b1=dict(timing(
            lambda: maxmin.fill_round(plan1, r1, l1, l1, f1),
            lambda: maxmin.fill_round_plain(plan1, r1, l1, l1, f1),
            14 * C2 + 12 * S2, 4 * int(l1.sum()) + 8 * S2),
            plan_ms=time_ms(lambda: maxmin.fill_plan(p1, c1, l1, None, S2)),
            plan_device_ms=graph_ms(lambda: maxmin.fill_plan(p1, c1, l1,
                                                             None, S2))))
    checks["captured_live_flows_batched"] = {
        "batched_full_width": cap["live"], "batched_above_gate": above["live"]}
    return records, checks


# the port's hand-written kernels, as the profiler names them
OUR_KERNELS = ("maxmin_solve_kernel", "fill_plan_kernel", "fill_round_kernel",
               "masked_min_kernel", "flash_mma_kernel", "flash_f32_kernel",
               "linear_scan_kernel")


# the per-name dicts of a profiled() summary, kept in the record, not printed
PROFILE_BULK = ("aten_ops", "device_kernels", "device_kernel_ms")


def profiled(fn) -> tuple:
    """Run ``fn`` under torch.profiler; returns its result and a summary:
    wall, device busy and idle share, kernel launches, host reads, the
    host ops and device kernels that take the most time.  The summary is
    counted from the trace's raw events in one pass; the profiler's
    per-event post-processing (``key_averages``) takes minutes at a few
    hundred thousand launches."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.autograd import profiler as autograd_profiler
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # Versions that build the per-event records on leaving the context get
    # none: nothing here reads them.
    parse0 = autograd_profiler.profile._parse_kineto_results
    autograd_profiler.profile._parse_kineto_results = lambda self, res: []
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        autograd_profiler.profile._parse_kineto_results = parse0
    t1 = time.perf_counter()
    host_n, host_ms, dev_n, dev_ms = Counter(), Counter(), Counter(), Counter()
    for e in prof.profiler.kineto_results.events():
        name, ms = e.name(), e.duration_ns() / 1e6
        if e.device_type() == DeviceType.CUDA:
            dev_n[name] += 1
            dev_ms[name] += ms
        else:
            host_n[name] += 1
            host_ms[name] += ms
    busy_s = sum(dev_ms.values()) / 1e3
    launches = sum(n for k, n in host_n.items() if "LaunchKernel" in k)
    assert launches > 0 and busy_s > 0, "no device work in the profiled run"
    ours = {}
    for name, n in dev_n.items():
        words = name.split("(")[0].split("<")[0].split()
        if words and words[-1] in OUR_KERNELS:
            k0, ms0 = ours.get(words[-1], (0, 0.0))
            ours[words[-1]] = (k0 + n, ms0 + dev_ms[name])

    def top(n, ms, k):
        return [(key[:80], n[key], v) for key, v in ms.most_common(k)]

    return out, dict(
        wall_s=wall, device_busy_s=busy_s, our_kernels_count_ms=ours,
        device_idle_share=1.0 - busy_s / wall, kernel_launches=launches,
        host_reads=host_n["aten::_local_scalar_dense"],
        # inclusive host time by op name (an op's children count again)
        top_host_ms=top(host_n, host_ms, 10),
        top_device_ms=top(dev_n, dev_ms, 8),
        device_kernel_ms=dict(dev_ms),
        aten_ops={k: n for k, n in host_n.items() if k.startswith("aten::")},
        device_kernels=dict(dev_n),
        summary_s=time.perf_counter() - t1)


def profile_phase(n_tasks: int, n_above: int, n_batched: int) -> dict:
    """The full-width cell cut to ``n_tasks``, compacted (bucket 2048) and
    dense (auto on the card), the above-gate cell cut to ``n_above``
    tasks, and the batched full-width cell (8 lanes, dense) cut to
    ``n_batched`` tasks, and the streamed full-width cell (in 8 windows)
    at ``n_tasks``, under torch.profiler: device busy and idle share,
    device time of each hand-written kernel, events/s (of all lanes),
    kernel launches and host reads per pass, the top host-side ops.
    Compaction may read the host no more often a pass than the dense
    run."""
    from repro_torch.core import engine
    from repro_torch.core.trace import (chunk_trace, filter_fitting,
                                        gwa_like_trace)

    out = {}
    for name, n_pm, n_vm, tasks, compact, lanes, stream in (
            ("full_width", 500, 4096, n_tasks, 2048, None, False),
            ("full_width_dense", 500, 4096, n_tasks, -1, None, False),
            ("above_gate", 1500, 8192, n_above, -1, None, False),
            ("batched_full_width", 500, 4096, n_batched, -1,
             FULL_WIDTH_SWEEP, False),
            # the streamed cell in 8 windows
            ("streaming_full_width", 500, 4096, n_tasks, -1, None, True)):
        trace = filter_fitting(gwa_like_trace("das2", tasks, seed=7), 64.0)
        spec, params = engine.make_cloud(n_pm=n_pm, n_vm=n_vm, pm_cores=64.0,
                                         pm_sched="ondemand", compact=compact,
                                         max_events=4_000_000)
        bp = params if lanes is None else sweep_params(params, lanes)
        wt = chunk_trace(trace, -(-trace.n // 8))

        def go():
            if not stream:
                return (run if lanes is None else run_batch)(
                    spec, trace, bp, "cuda")
            return timed_call(lambda: engine.simulate_stream(
                spec, wt, bp, device="cuda"), "cuda")

        (res, _), prof = profiled(go)
        # a pass serves every lane: the busiest lane's events count them
        events = int(res.n_events.sum())
        passes = int(res.n_events.max())
        out[name] = dict(tasks=int(trace.n), events=events, passes=passes,
                         **prof, events_per_s=events / prof["wall_s"],
                         kernel_launches_per_pass=prof["kernel_launches"]
                         / passes,
                         host_reads_per_pass=prof["host_reads"] / passes)
        print(json.dumps({f"profile_{name}": {
            k: v for k, v in out[name].items()
            if k not in PROFILE_BULK}}))
    a, b = out["full_width"], out["full_width_dense"]
    assert a["events"] == b["events"], (a["events"], b["events"])
    assert out["streaming_full_width"]["events"] == b["events"], (
        out["streaming_full_width"]["events"], b["events"])
    # what compaction adds a pass, by aten op and by device kernel
    for key in ("aten_ops", "device_kernels"):
        extra = {k: (a[key].get(k, 0) - b[key].get(k, 0)) / a["events"]
                 for k in set(a[key]) | set(b[key])}
        out[f"compaction_extra_{key}_per_pass"] = sorted(
            ((k, v) for k, v in extra.items() if v), key=lambda x: -abs(x[1]))
    print(json.dumps({k: [(n[:100], v) for n, v in rows[:12]]
                      for k, rows in out.items()
                      if k.startswith("compaction_extra")}))
    assert a["host_reads_per_pass"] <= b["host_reads_per_pass"], (
        "compaction reads the host more often than the dense pass",
        a["host_reads_per_pass"], b["host_reads_per_pass"])
    return out


def timed_call(fn, device):
    """``(fn(), wall s)``, the wall ending after the device's queue
    drained."""
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run(spec, trace, params, device):
    from repro_torch.core import engine
    return timed_call(lambda: engine.simulate(spec, trace, params=params,
                                              device=device), device)


def run_batch(spec, trace, params, device):
    """``engine.simulate_batch`` timed as :func:`run` times one scenario."""
    from repro_torch.core import engine
    return timed_call(lambda: engine.simulate_batch(spec, trace, params,
                                                    device=device), device)


def sweep_params(params, lanes: dict):
    """``params`` with each parameter of ``lanes`` set to its values, one a
    lane (an f32 or int32 [B] tensor)."""
    kw = {k: torch.tensor(v, dtype=torch.int32 if k.endswith("_sched")
                          else torch.float32) for k, v in lanes.items()}
    return dataclasses.replace(params, **kw)


# live flows per solve, by the fused solve's code path: none (no round),
# one warp with no barrier, one warp's register sort, the block sort in
# shared memory, the global workspace
LIVE_BINS = ((0, 0), (1, 16), (17, 32), (33, 1024), (1025, 2 ** 31))


def live_histogram(counts: np.ndarray) -> dict:
    return {f"{lo}-{hi}" if hi < 2 ** 31 else f">{lo - 1}":
            int(((counts >= lo) & (counts <= hi)).sum())
            for lo, hi in LIVE_BINS}


def _bits(readings: dict) -> dict:
    return {k: v.cpu().numpy().tobytes() for k, v in readings.items()}


# Tasks of the kernel phases' captures and of --compare-parent's profiled
# run.
CAPTURE_TASKS = 150
# Tasks of the profile phase's full-width, batched and streamed cells, cut
# from CAPTURE_TASKS to keep the script inside its time limit (the
# profiler's stop and summary grow with the events it holds); launches
# and reads a pass are averages over the profiled passes
PROFILE_TASKS = 60

# name, PMs, VMs, tasks (None: --tasks), PM policy, spec.compact, bucket.
# The auto rule (-1) runs dense on the card; 2048 is the reference's auto
# bucket for this cloud, next_pow2(4P + 32), given explicitly.
MAIN_CELLS = (
    ("full_width", 500, 4096, None, "ondemand", 2048, 2048),
    ("full_width_dense", 500, 4096, None, "ondemand", -1, 0),
    # S = 4P + 2 + V = 14194 > MAX_SOLVE_S: the round-wise path
    ("above_gate", 1500, 8192, 100, "ondemand", -1, 0),
    # the reference default consolidate_idle_frac = 0.6
    # 1000 tasks since slice 6, to keep the script's time
    ("migrating_full_width", 500, 4096, 1000, "consolidate", 2048, 2048),
)


def migrations_done(spec, params, st) -> float:
    """Completed live migrations, read from the state after the run: only
    a migration's flow has a NIC-out spreader as its provider, and each
    moves the VM's memory (``vm_mem_mb``) once."""
    lay = spec.layout
    nic = st.processed[lay.netout0:lay.netout0 + spec.n_pm]
    return float(nic.double().sum()) / float(params.vm_mem_mb)


def main_path(n_tasks: int) -> tuple[dict, dict, dict]:
    """The full-width cell compacted (bucket 2048) and dense (the auto rule
    on the card) on one trace, the above-gate cell, and the migrating
    full-width cell, each with the launch counters set to 0 just before
    and read just after.  Returns the records, each cell's readings and
    its per-task outputs (bytes)."""
    import warnings

    from repro_torch import kernels
    from repro_torch.core import engine, fairshare
    from repro_torch.core import machine as mc
    from repro_torch.core.loop import compact as cpk
    from repro_torch.core.loop.state import TASK_DONE, TASK_REJECTED
    from repro_torch.core.trace import filter_fitting, gwa_like_trace

    out, readings, outputs = {}, {}, {}
    for name, n_pm, n_vm, tasks, pm_sched, compact, bucket in MAIN_CELLS:
        tasks = n_tasks if tasks is None else tasks
        trace = filter_fitting(gwa_like_trace("das2", tasks, seed=7), 64.0)
        spec, params = engine.make_cloud(
            n_pm=n_pm, n_vm=n_vm, pm_cores=64.0, pm_sched=pm_sched,
            max_migrations=4, compact=compact, max_events=4_000_000)
        # each solve's live-flow count, summed on the device (one small
        # reduction a pass in every cell, no host read in the run) and
        # read once after it
        lives = []
        rates0 = fairshare.SCHEDULERS["maxmin"]

        def rates(prov, cons, p_l, live, perf, **kw):
            lives.append(live.sum())
            return rates0(prov, cons, p_l, live, perf, **kw)

        fairshare.SCHEDULERS["maxmin"] = rates
        kernels.reset_launch_counts()
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                res, wall = run(spec, trace, params, "cuda")
        finally:
            fairshare.SCHEDULERS["maxmin"] = rates0
        launches = dict(kernels.launch_counts(),
                        **kernels.sub_launch_counts())
        events = int(res.n_events)
        counts = torch.stack(lives).cpu().numpy()
        ts = res.state.task_state.cpu().numpy()
        readings[name] = _bits(res.readings(spec))
        outputs[name] = _outputs(res)
        rd = {k: float(v.sum()) for k, v in res.readings(spec).items()}
        rec = dict(n_pm=n_pm, n_vm=n_vm, tasks=int(trace.n),
                   pm_sched=pm_sched, compact=compact,
                   bucket=cpk.compact_bucket(spec, "cuda"),
                   spreaders=spec.layout.S, events=events, wall_s=wall,
                   events_per_s=events / wall, launches=launches,
                   completed=int((ts == TASK_DONE).sum()),
                   rejected=int((ts == TASK_REJECTED).sum()),
                   overflow=bool(res.overflow), t_end=float(res.t_end),
                   readings_j=rd, solves=int(counts.size),
                   live_flows_max=int(counts.max()),
                   live_flows_hist=live_histogram(counts),
                   compaction_replays=len(caught))
        moved = migrations_done(spec, params, res.state)
        rec.update(migrations=round(moved), migrations_raw=moved,
                   migrating_at_end=int((res.state.vstage
                                         == mc.VM_MIGRATING).sum()))
        print(json.dumps({name: rec}))
        assert not rec["overflow"], f"{name}: VM slot pool overflowed"
        assert not caught, (f"{name}: compaction bucket overflowed",
                            [str(w.message) for w in caught])
        assert rec["completed"] + rec["rejected"] == rec["tasks"], (
            f"{name}: unfinished tasks")
        assert launches["masked_min"] == events, (
            f"{name}: masked_min launched {launches['masked_min']} times in "
            f"{events} advance passes")
        assert rec["bucket"] == bucket, (name, rec["bucket"])
        if name == "above_gate":
            assert launches["maxmin_solve"] == 0, launches
            assert launches["fill_stats"] >= events, launches
            # one plan per solve that runs a round, at most one per pass
            assert 0 < launches["fill_plan"] <= events, launches
        else:
            assert launches["maxmin_solve"] == events, launches
            assert launches["fill_plan"] == 0, launches
        # every migration ran to its end, so started = completed
        assert rec["migrating_at_end"] == 0, rec["migrating_at_end"]
        assert abs(moved - round(moved)) < 1e-2, (
            f"{name}: NIC-out work is not whole migrations", moved)
        if pm_sched == "consolidate":
            assert rec["migrations"] > 0, f"{name}: no migration"
        else:
            assert rec["migrations"] == 0, rec["migrations"]
        out[name] = rec
    # compaction is exact: the dense run is its bit-identical replay target
    a, b = out["full_width"], out["full_width_dense"]
    for k in ("events", "completed", "rejected", "t_end"):
        assert a[k] == b[k], (k, a[k], b[k])
    assert readings["full_width"] == readings["full_width_dense"], (
        "full width: compacted and dense readings differ")
    out["full_width"]["readings_bit_equal_to_dense"] = True
    return out, readings, outputs


def _outputs(res) -> dict:
    """The per-task outputs and end state of a run, as bytes: events,
    clock, completions, rejections, the pool-overflow flag."""
    return {k: getattr(res, k).cpu().numpy().tobytes()
            for k in ("n_events", "t_end", "completion", "rejected",
                      "overflow")}


def _flat(res, spec) -> dict:
    """Every leaf of a result, its readings included, as numpy arrays."""
    from repro_torch.core import engine
    out = engine.to_numpy(res)
    out.update({f"readings.{k}": v.cpu().numpy()
                for k, v in res.readings(spec).items()})
    return out


def _lane_bits_equal(batch: dict, lane: int, single: dict) -> list:
    """The leaves where lane ``lane`` of a batch differs from a single run
    (an empty list when every leaf is bit-equal)."""
    return [k for k in single
            if not _bit_equal(batch[k][lane], single[k])]


def _assert_close(name: str, got: dict, want: dict):
    """Integers and event counts exact, floats within rtol 1e-5 / atol
    1e-6, the Kahan low words not compared (card against CPU)."""
    assert set(got) == set(want), (name, set(got) ^ set(want))
    for k in want:
        if k.endswith(UNCOMPARED):
            continue
        if want[k].dtype.kind == "f":
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name}: {k}")
        else:
            assert np.array_equal(got[k].astype(np.int64),
                                  want[k].astype(np.int64)), (name, k)


# name, PMs, VMs, tasks (None: --tasks), PM policy, spec.compact, lanes, and
# the lane that must equal the main-path cell named last
BATCHED_CELLS = (
    ("batched_full_width", 500, 4096, None, "ondemand", -1,
     FULL_WIDTH_SWEEP, 2, "full_width_dense"),
    ("batched_above_gate", 1500, 8192, 100, "ondemand", -1,
     ABOVE_GATE_SWEEP, 0, "above_gate"),
)


def batched_path(n_tasks: int, main: dict, main_bits: dict,
                 device: str = "cuda") -> dict:
    """Each batched cell once through ``simulate_batch``, the launch
    counters set to 0 just before and read just after: every lane's
    events, the passes, wall s, aggregate events/s (the lanes' events over
    the wall) beside the single main-path cell's, and the hand-written
    kernels' launches, one a pass for all lanes.  One lane must equal its
    main-path cell (events, completions, rejections, every reading bit for
    bit); in the full-width batch the last lane (500 MB/s, 400 MB) must
    also equal its own single run, every leaf bit for bit."""
    from repro_torch import kernels
    from repro_torch.core import engine
    from repro_torch.core.loop.state import TASK_DONE, TASK_REJECTED
    from repro_torch.core.trace import filter_fitting, gwa_like_trace
    from repro_torch.experiments import pareto

    out = {}
    for (name, n_pm, n_vm, tasks, pm_sched, compact, lanes, same_lane,
         same_cell) in BATCHED_CELLS:
        tasks = n_tasks if tasks is None else tasks
        trace = filter_fitting(gwa_like_trace("das2", tasks, seed=7), 64.0)
        spec, params = engine.make_cloud(
            n_pm=n_pm, n_vm=n_vm, pm_cores=64.0, pm_sched=pm_sched,
            compact=compact, max_events=4_000_000)
        # the lanes as a Pareto sweep's points (experiments.pareto), run
        # through experiments.shard.run_batch on the one device
        points = [dataclasses.replace(params, **dict(zip(lanes, values)))
                  for values in zip(*lanes.values())]
        kernels.reset_launch_counts()
        front, wall = timed_call(lambda: pareto.sweep(
            spec, trace, points, devices=[device]), device)
        res = front.result
        launches = dict(kernels.launch_counts(), **kernels.sub_launch_counts())
        flat = _flat(res, spec)
        events = flat["n_events"].astype(int).tolist()
        ts = flat["state.task_state"]
        done = (ts == TASK_DONE).sum(-1).tolist()
        rejected = (ts == TASK_REJECTED).sum(-1).tolist()
        passes = launches["masked_min"]
        ref = main[same_cell]
        rec = dict(n_pm=n_pm, n_vm=n_vm, tasks=int(trace.n), lanes=lanes,
                   lane_events=events, passes=passes, wall_s=wall,
                   aggregate_events_per_s=sum(events) / wall,
                   single_cell=same_cell,
                   single_events_per_s=ref["events_per_s"],
                   launches=launches, completed=done, rejected=rejected,
                   overflow=flat["overflow"].tolist(),
                   pareto_rows=front.rows,
                   pareto_frontier=front.frontier.tolist())
        print(json.dumps({name: rec}))
        assert front.frontier.size > 0 and all(
            r["tasks_done"] == d for r, d in zip(front.rows, done)), (
            name, front.rows)
        assert all(d + r == trace.n for d, r in zip(done, rejected)), (
            f"{name}: unfinished tasks")
        assert not any(rec["overflow"]), f"{name}: VM slot pool overflowed"
        if device == "cuda":
            # one launch a pass serves every lane; the pass count is the
            # busiest lane's event count
            assert passes == max(events), (name, passes, max(events))
            if name == "batched_above_gate":
                assert launches["maxmin_solve"] == 0, launches
                assert 0 < launches["fill_plan"] <= passes, launches
            else:
                assert launches["maxmin_solve"] == passes, launches
        # the lane of the main-path cell: the same events, completions,
        # rejections and readings, bit for bit
        got = {k[len("readings."):]: flat[k][same_lane].tobytes()
               for k in flat if k.startswith("readings.")}
        assert got == main_bits[same_cell], (
            f"{name}: lane {same_lane} readings differ from {same_cell}")
        assert (events[same_lane], done[same_lane], rejected[same_lane]) == (
            ref["events"], ref["completed"], ref["rejected"]), (
            name, events[same_lane], ref["events"])
        rec[f"lane_{same_lane}_bit_equal_to_{same_cell}"] = True
        if name == "batched_full_width":
            last = len(events) - 1
            one = sweep_params(params, {k: v[last] for k, v in lanes.items()})
            single, single_wall = run(spec, trace, one, device)
            bad = _lane_bits_equal(flat, last, _flat(single, spec))
            assert not bad, (f"{name}: lane {last} differs from its single "
                             f"run in {bad[:5]}")
            rec.update({f"lane_{last}_bit_equal_to_single_run": True,
                        f"lane_{last}_single_wall_s": single_wall})
        out[name] = rec
    return out


MATRIX_TASKS = 200


def batched_matrix(n_tasks: int = MATRIX_TASKS, device: str = "cuda",
                   n_pm: int = 20, n_vm: int = 1024) -> dict:
    """The scheduler tournament (experiments.tournament.run) at the
    cross-check's size: 20 PM x 1024 VM,
    the cross-check's trace, bucket 128 (given explicitly, so that each
    lane compacts on the card), 15 lanes, one for each (vm_sched,
    pm_sched) pair.  Twice on the card, bit-identical; once batched on the
    CPU (integers and events exact, floats within rtol 1e-5 / atol 1e-6);
    the five firstfit lanes each bit-equal to their single card run; at
    least one migrating lane migrates."""
    import warnings

    from repro_torch.core import engine
    from repro_torch.experiments import tournament
    from repro_torch.sched import registry
    from repro_torch.core.trace import filter_fitting, gwa_like_trace

    trace = filter_fitting(gwa_like_trace("das2", n_tasks, seed=7), 64.0)
    spec, params = engine.make_cloud(n_pm=n_pm, n_vm=n_vm, pm_cores=64.0,
                                     compact=128, max_events=4_000_000)
    pairs = [(v, p) for v in range(len(registry.names("vm")))
             for p in range(len(registry.names("pm")))]

    def run_tournament(dev):
        """The lanes as experiments.tournament.run scores them, through
        experiments.shard.run_batch on the one device."""
        return timed_call(lambda: tournament.run(
            spec, trace, params, schedulers=pairs, devices=[dev]), dev)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ta, wall_a = run_tournament(device)
        tb, wall_b = run_tournament(device)
    assert not caught, ("batched_matrix: a compaction bucket overflowed",
                        [str(w.message) for w in caught])
    tc, wall_c = run_tournament("cpu")
    assert ta.rows == tb.rows, "batched_matrix: two card runs' rows differ"
    fa, fb, fc = (_flat(x.result, spec) for x in (ta, tb, tc))
    for k in fa:
        assert fa[k].tobytes() == fb[k].tobytes(), (
            f"batched_matrix: two card runs differ in {k}")
    _assert_close("batched_matrix card vs cpu", fa, fc)
    singles = {}
    for i, (v, p) in enumerate(pairs):
        if v != 0:
            continue
        one = sweep_params(params, {"vm_sched": v, "pm_sched": p})
        single, wall = run(spec, trace, one, device)
        bad = _lane_bits_equal(fa, i, _flat(single, spec))
        assert not bad, (f"batched_matrix: firstfit lane {i} differs from "
                         f"its single run in {bad[:5]}")
        singles[registry.names("pm")[p]] = wall
    migrated = [bool(np.abs(fa["state.vm_saved_pr"][i]).sum() > 0)
                for i in range(len(pairs))]
    rec = dict(tasks=int(trace.n), lanes=[
        f"{registry.names('vm')[v]}/{registry.names('pm')[p]}"
        for v, p in pairs], lane_events=fa["n_events"].astype(int).tolist(),
        card_wall_s=[wall_a, wall_b], cpu_wall_s=wall_c,
        aggregate_events_per_s=float(fa["n_events"].sum()) / wall_a,
        firstfit_single_wall_s=singles, migrated=migrated,
        leaves_bit_equal_card_cpu=sum(fa[k].tobytes() == fc[k].tobytes()
                                      for k in fa), leaves=len(fa),
        tournament_rows=ta.rows)
    print(json.dumps({"batched_matrix": rec}))
    for row, events, (v, p) in zip(ta.rows, rec["lane_events"], pairs):
        assert (row["vm_sched"], row["pm_sched"], row["events"]) == (
            registry.names("vm")[v], registry.names("pm")[p], events), row
    assert any(migrated[i] for i, (_, p) in enumerate(pairs) if p >= 2), (
        "batched_matrix: no migrating lane migrated")
    return rec


def cross_check(pm_sched: str = "alwayson") -> tuple[dict, dict]:
    """20 PM x 1024 VM under 200 tasks, compacted (bucket 128, the
    reference's auto bucket, given explicitly since auto runs dense on the
    card), twice on the card, bit-identical, and once on the CPU: integers
    and event counts exact, floats within rtol 1e-5 / atol 1e-6.  Returns
    the record and the card run's leaves."""
    from repro_torch.core import engine
    from repro_torch.core.loop import compact as cpk
    from repro_torch.core.trace import filter_fitting, gwa_like_trace

    trace = filter_fitting(gwa_like_trace("das2", 200, seed=7), 64.0)
    spec, params = engine.make_cloud(n_pm=20, n_vm=1024, pm_cores=64.0,
                                     pm_sched=pm_sched, compact=128,
                                     max_events=4_000_000)
    assert cpk.compact_bucket(spec, "cuda") == 128
    a, wall_a = run(spec, trace, params, "cuda")
    b, wall_b = run(spec, trace, params, "cuda")
    c, wall_c = run(spec, trace, params, "cpu")
    fa, fb, fc = (engine.to_numpy(x) for x in (a, b, c))
    for k in fa:
        assert fa[k].tobytes() == fb[k].tobytes(), (
            f"two card runs differ in {k}")
    _assert_close("card vs cpu", fa, fc)
    bit_equal = sum(fa[k].tobytes() == fc[k].tobytes() for k in fa)
    name = "cross_check_20x1024" + ("" if pm_sched == "alwayson"
                                    else f"_{pm_sched}")
    rec = dict(events=int(a.n_events),
               bucket=cpk.compact_bucket(spec, "cuda"),
               pm_sched=pm_sched, card_wall_s=[wall_a, wall_b],
               cpu_wall_s=wall_c, leaves=len(fa),
               leaves_bit_equal_card_cpu=bit_equal,
               migrated=bool(np.abs(fa["state.vm_saved_pr"]).sum() > 0))
    print(json.dumps({name: rec}))
    if pm_sched in ("consolidate", "defrag", "evacuate"):
        assert rec["migrated"], f"{name}: no migration"
    return rec, fa


def _stream_vs_mono(stream: dict, mono: dict) -> list:
    """The leaves of a monolithic run (but the per-task state, whose axis
    is the slot pool in a stream) where a stream's bits differ."""
    return [k for k in mono
            if not k.startswith(("state.task_", "state.t_done",
                                 "state.vm_task"))
            and stream[k].tobytes() != mono[k].tobytes()]


# Windows of the streamed cells: 1000 tasks in 4 windows at full width
# (the default pool of 4096 + 256 slots), 200 in 4 in the cross-check.
STREAM_WINDOW = 256
CROSS_STREAM_WINDOW = 64
# streaming_batched's depth, cut from --tasks to keep the script inside its
# time limit (2000 tasks took 87 s of the first full run's 1090)
STREAM_BATCHED_TASKS = 300


def streaming_path(n_tasks: int, main: dict, main_bits: dict,
                   main_outputs: dict, device: str = "cuda") -> dict:
    """streaming_full_width: the full_width_dense cell of MAIN_CELLS (its
    cloud, trace and spec) through ``engine.simulate_stream`` on
    ``chunk_trace(trace, STREAM_WINDOW)``, which must equal the monolithic
    run bit for bit (events, clock, completions, rejections, overflow,
    every reading).  streaming_batched: the batched_full_width lanes of
    BATCHED_CELLS through ``experiments.shard.simulate_stream_batch`` on
    the same cloud, its trace cut to STREAM_BATCHED_TASKS tasks; the lane
    of the main-path cell must equal the single stream of that trace in
    every leaf (streaming_full_width itself when not cut), and each
    main-path kernel launch a pass serves every lane.  The launch counters are set to 0 just
    before each run and read just after."""
    from repro_torch import kernels
    from repro_torch.core import engine
    from repro_torch.core.loop.state import TASK_DONE, TASK_REJECTED
    from repro_torch.core.trace import (chunk_trace, filter_fitting,
                                        gwa_like_trace)
    from repro_torch.experiments import shard

    def timed_run(fn):
        kernels.reset_launch_counts()
        res, wall = timed_call(fn, device)
        return res, wall, dict(kernels.launch_counts(),
                               **kernels.sub_launch_counts())

    def per_pass(launches, passes):
        return {k: v / passes for k, v in launches.items()}

    _, n_pm, n_vm, tasks, pm_sched, compact, _ = {
        c[0]: c for c in MAIN_CELLS}["full_width_dense"]
    tasks = n_tasks if tasks is None else tasks
    trace = filter_fitting(gwa_like_trace("das2", tasks, seed=7), 64.0)
    spec, params = engine.make_cloud(
        n_pm=n_pm, n_vm=n_vm, pm_cores=64.0, pm_sched=pm_sched,
        compact=compact, max_events=4_000_000)
    wt = chunk_trace(trace, STREAM_WINDOW)
    res, wall, launches = timed_run(lambda: engine.simulate_stream(
        spec, wt, params, device=device))
    single = _flat(res, spec)
    events = int(res.n_events)
    ts = res.completion.cpu().numpy()
    out = {}
    rec = dict(n_pm=n_pm, n_vm=n_vm, tasks=int(trace.n),
               window=STREAM_WINDOW, windows=wt.n_windows,
               slots=engine.default_n_slots(spec, STREAM_WINDOW),
               events=events, wall_s=wall, events_per_s=events / wall,
               single_cell="full_width_dense",
               single_events_per_s=main["full_width_dense"]["events_per_s"],
               launches=launches, launches_per_pass=per_pass(launches,
                                                             events),
               completed=int(np.isfinite(ts).sum()),
               rejected=int(res.rejected.sum()),
               overflow=bool(res.overflow),
               window_t_end=res.window_t_end.cpu().tolist())
    print(json.dumps({"streaming_full_width": rec}))
    want = main_outputs["full_width_dense"]
    got = _outputs(res)
    assert got == want, ("streaming_full_width differs from "
                         "full_width_dense in",
                         [k for k in want if got[k] != want[k]])
    assert _bits(res.readings(spec)) == main_bits["full_width_dense"], (
        "streaming_full_width: readings differ from full_width_dense")
    assert rec["completed"] + rec["rejected"] == rec["tasks"]
    if device == "cuda":
        assert launches["masked_min"] == events, launches
        assert launches["maxmin_solve"] == events, launches
        assert launches["fill_plan"] == 0, launches
    rec["bit_equal_to_full_width_dense"] = True
    out["streaming_full_width"] = rec

    (_, _, _, _, _, _, lanes, same_lane, _) = {
        c[0]: c for c in BATCHED_CELLS}["batched_full_width"]
    bp = sweep_params(params, lanes)
    if tasks > STREAM_BATCHED_TASKS:
        # the cut depth: lane 2 is held against the single stream of the
        # same cut trace
        trace = filter_fitting(gwa_like_trace("das2", STREAM_BATCHED_TASKS,
                                              seed=7), 64.0)
        wt = chunk_trace(trace, STREAM_WINDOW)
        single, single_wall = timed_call(lambda: _flat(engine.simulate_stream(
            spec, wt, params, device=device), spec), device)
        out["streaming_full_width"]["cut_single_wall_s"] = single_wall
    res, wall, launches = timed_run(lambda: shard.simulate_stream_batch(
        spec, wt, bp, devices=[device]))
    flat = _flat(res, spec)
    lane_events = flat["n_events"].astype(int).tolist()
    passes = launches["masked_min"] if device == "cuda" else max(lane_events)
    st = flat["state.task_state"]
    rec = dict(tasks=int(trace.n), lanes=lanes, window=STREAM_WINDOW,
               lane_events=lane_events, passes=passes, wall_s=wall,
               aggregate_events_per_s=sum(lane_events) / wall,
               batched_cell="batched_full_width",
               batched_aggregate_events_per_s=main["batched_full_width"][
                   "aggregate_events_per_s"],
               launches=launches, launches_per_pass=per_pass(launches,
                                                             passes),
               completed=np.isfinite(flat["completion"]).sum(-1).tolist(),
               rejected=flat["rejected"].sum(-1).tolist(),
               overflow=flat["overflow"].tolist(),
               live_tasks_at_end=int(((st != TASK_DONE)
                                      & (st != TASK_REJECTED)).sum()))
    print(json.dumps({"streaming_batched": rec}))
    assert not any(rec["overflow"]), "streaming_batched: pool overflowed"
    assert all(d + r == trace.n for d, r in zip(rec["completed"],
                                                rec["rejected"]))
    bad = _lane_bits_equal(flat, same_lane, single)
    assert not bad, (f"streaming_batched: lane {same_lane} differs from "
                     f"its single stream in {bad[:5]}")
    if device == "cuda":
        # one launch a pass serves every lane.  A window's loop runs while
        # any lane has not reached the hand-over, so the passes are the
        # sum over the windows of the busiest lane's events there: at
        # least the busiest lane's total, far below the lanes' sum.
        assert max(lane_events) <= passes < 2 * max(lane_events), (
            passes, lane_events)
        assert launches["maxmin_solve"] == passes, launches
    rec[f"lane_{same_lane}_bit_equal_to_single_stream"] = True
    out["streaming_batched"] = rec
    return out


def streaming_cross_check(mono: dict, device: str = "cuda",
                          n_pm: int = 20, n_vm: int = 1024) -> dict:
    """The cross-check cell (20 PM x 1024 VM, 200 tasks, alwayson, bucket
    128) through ``engine.simulate_stream`` at W = CROSS_STREAM_WINDOW:
    twice on the card, bit-identical, and bit-equal to the cell's
    monolithic card run ``mono`` (every leaf but the per-task state);
    once on the CPU (integers exact, floats within rtol 1e-5 / atol
    1e-6).  Then a ``gwa_window_stream`` generator of 200 das2 tasks in
    windows of CROSS_STREAM_WINDOW, card against CPU likewise."""
    import warnings

    from repro_torch.core import engine
    from repro_torch.core.trace import (chunk_trace, filter_fitting,
                                        gwa_like_trace)
    from repro_torch.data.pipeline import gwa_window_stream

    trace = filter_fitting(gwa_like_trace("das2", 200, seed=7), 64.0)
    spec, params = engine.make_cloud(n_pm=n_pm, n_vm=n_vm, pm_cores=64.0,
                                     pm_sched="alwayson", compact=128,
                                     max_events=4_000_000)
    wt = chunk_trace(trace, CROSS_STREAM_WINDOW)

    def go(windows, dev):
        res, wall = timed_call(lambda: engine.simulate_stream(
            spec, windows, params, device=dev), dev)
        return _flat(res, spec), wall

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fa, wall_a = go(wt, device)
        fb, wall_b = go(wt, device)
    assert not caught, ("streaming_cross_check: a bucket overflowed",
                        [str(w.message) for w in caught])
    fc, wall_c = go(wt, "cpu")
    for k in fa:
        assert fa[k].tobytes() == fb[k].tobytes(), (
            f"streaming_cross_check: two card runs differ in {k}")
    bad = _stream_vs_mono(fa, mono)
    assert not bad, ("streaming_cross_check: differs from the monolithic "
                     "card run in", bad[:5])
    _assert_close("streaming_cross_check card vs cpu", fa, fc)

    def gen():
        return gwa_window_stream("das2", 200, CROSS_STREAM_WINDOW,
                                 max_cores=64, seed=7)

    ga, wall_ga = go(gen(), device)
    gc, wall_gc = go(gen(), "cpu")
    _assert_close("streaming_cross_check generator card vs cpu", ga, gc)
    rec = dict(tasks=int(trace.n), window=CROSS_STREAM_WINDOW,
               windows=wt.n_windows, events=int(fa["n_events"]),
               card_wall_s=[wall_a, wall_b], cpu_wall_s=wall_c,
               leaves=len(fa),
               leaves_bit_equal_card_cpu=sum(
                   fa[k].tobytes() == fc[k].tobytes() for k in fa),
               bit_equal_to_monolithic_card_run=True,
               generator=dict(tasks=200, events=int(ga["n_events"]),
                              card_wall_s=wall_ga, cpu_wall_s=wall_gc,
                              leaves_bit_equal_card_cpu=sum(
                                  ga[k].tobytes() == gc[k].tobytes()
                                  for k in ga)))
    print(json.dumps({"streaming_cross_check": rec}))
    return rec


# ---------------------------------------------------------------------------
# The standalone sharing core: the paper's validation figures, the Fig. 12
# load at its largest parallelism, networks below and above the solve's
# gate, and the IaaS facade
# ---------------------------------------------------------------------------

# Fig. 11/12 synthetic load at the largest parallelism of
# benchmarks/sharing_perf.py (PARALLELISM_FULL): tasks, parallelism, the
# spreader's capacity (units/s), Table 1's p_min and p_max (W)
FIG12 = dict(tasks=10_000, parallel=10_000, capacity=2500.0, p_min=368.8,
             p_max=722.7)
# the network cells: nodes, transfers, registration window (s), seed
NETWORK_CELLS = {"network_full_width": (1000, 5000, 600.0, 19),
                 "network_cross_check": (100, 500, 60.0, 19),
                 "network_above_gate": (6000, 300, 60.0, 19)}
# passes of the profiled slice of the two large sharing cells
SHARING_PROFILE_PASSES = 1500
NETWORK_BW = (62.5, 125.0, 250.0, 1250.0)   # MB/s
ROUTE_CAP = 50.0                             # MB/s, every 10th transfer


def exact_single_provider(works, capacity, limits) -> np.ndarray:
    """Exact completion times on one provider, max-min with per-flow caps
    (float64; the closed form of benchmarks/validation.py, Fig. 7)."""
    works = np.asarray(works, np.float64).copy()
    limits = np.asarray(limits, np.float64)
    t = 0.0
    done = np.full(len(works), np.nan)
    active = works > 0
    while active.any():
        rates = np.minimum(capacity / active.sum(), limits)
        for _ in range(len(works)):     # hand capped flows' headroom on
            free = capacity - rates[active].sum()
            uncapped = active & (rates < limits)
            if free <= 1e-12 or not uncapped.any():
                break
            rates[uncapped] += free / uncapped.sum()
            rates = np.minimum(rates, limits)
        with np.errstate(divide="ignore"):
            ttc = np.where(active & (rates > 0), works / rates, np.inf)
        dt = ttc[active].min()
        works[active] -= rates[active] * dt
        t += dt
        newly = active & (works <= 1e-9)
        done[newly] = t
        active = active & ~newly
    return done


def staircase_energy(starts, run_s, t_end, p_min, p_max, cores) -> float:
    """Fig. 10's analytic integral: between events k single-core VMs are
    busy, so the PM draws p_min + k / cores * (p_max - p_min)."""
    starts = np.asarray(starts, np.float64)
    ends = starts + run_s
    events = np.unique(np.concatenate([starts, ends, [0.0, t_end]]))
    total = 0.0
    for a, b in zip(events[:-1], events[1:]):
        k = ((starts <= (a + b) / 2) & (ends > (a + b) / 2)).sum()
        total += (p_min + k / cores * (p_max - p_min)) * (b - a)
    return total


def shared_spreader_closed_form(arrival, work, capacity, p_idle, p_span):
    """Float64 event-driven solution of single-core flows (p_l = 1) on one
    spreader of ``capacity``: every live flow runs at min(1, capacity /
    n_live), so all live flows drain alike and a flow ends when the work a
    flow has done since the start reaches its arrival mark plus its work
    (a heap of those marks).  Returns completion times, the energy of the
    linear power model and the most flows live at once."""
    import heapq
    order = np.argsort(arrival, kind="stable")
    arrival = np.asarray(arrival, np.float64)
    work = np.asarray(work, np.float64)
    done = np.full(len(work), np.inf)
    heap, t, done_work, energy, i, peak = [], 0.0, 0.0, 0.0, 0, 0
    while i < len(order) or heap:
        n_live = len(heap)
        rate = min(1.0, capacity / n_live) if n_live else 0.0
        t_arr = arrival[order[i]] if i < len(order) else np.inf
        t_end = t + (heap[0][0] - done_work) / rate if heap else np.inf
        t_new = min(t_arr, t_end)
        energy += (p_idle + p_span * min(1.0, n_live * rate / capacity)) * (
            t_new - t)
        done_work += rate * (t_new - t)
        t = t_new
        if t_arr <= t_end:
            heapq.heappush(heap, (done_work + work[order[i]], order[i]))
            i += 1
        else:
            done[heapq.heappop(heap)[1]] = t
        peak = max(peak, len(heap))
    return done, energy, peak


def _sharing_flat(res) -> dict:
    return {k: getattr(res, k).cpu().numpy() for k in res._fields}


def _sharing_close(name: str, card: dict, cpu: dict):
    """``n_events`` and ``ok`` exact, floats within RTOL / ATOL."""
    assert int(card["n_events"]) == int(cpu["n_events"]), (
        name, int(card["n_events"]), int(cpu["n_events"]))
    assert bool(card["ok"]) == bool(cpu["ok"]), name
    for k in ("completion", "t_end", "energy", "processed"):
        np.testing.assert_allclose(card[k], cpu[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} card vs cpu: {k}")


def _counted(fn, device):
    """``fn()`` with the launch counters set to 0 just before and read just
    after: ``(result, wall s, launches)``."""
    from repro_torch import kernels
    kernels.reset_launch_counts()
    out, wall = timed_call(fn, device)
    return out, wall, dict(kernels.launch_counts(),
                           **kernels.sub_launch_counts())


def sharing_validation(device: str = "cuda") -> dict:
    """The paper's validation figures through the port's sharing core and
    engine (the inputs of benchmarks/validation.py): Fig. 7 against the
    exact single-provider solution, Fig. 8's uncorrected completions no
    later than the corrected ones, Fig. 9 against 15/60/60/30 s, Fig. 10
    (``simulate_batch`` over four power models) against the analytic
    staircase integral within 2%.  Each runs on ``device`` with the
    counters set to 0 just before and read just after, and again on the
    CPU: events exact, floats within RTOL / ATOL."""
    from repro_torch.core import engine
    from repro_torch.core.energy import PowerStateTable
    from repro_torch.core.network import make_topology, transfers_problem
    from repro_torch.core.sharing import SharingProblem, run_sharing

    def both(build, name):
        cells = {}
        for dev in (device, "cpu"):
            res, wall, launches = _counted(
                lambda: _sharing_flat(run_sharing(build(dev))), dev)
            cells[dev] = (res, wall, launches)
        _sharing_close(name, cells[device][0], cells["cpu"][0])
        res, wall, launches = cells[device]
        if device == "cuda":
            assert launches["maxmin_solve"] == int(res["n_events"]), (
                name, launches)
        return res, dict(events=int(res["n_events"]), wall_s=wall,
                         cpu_wall_s=cells["cpu"][1], launches=launches)

    out = {}
    works = [2.0 * (i + 1) for i in range(8)]
    res, rec = both(lambda dev: SharingProblem.build(
        perf=[4.0], provider=[0] * 8, consumer=[0] * 8, amount=works,
        limit=[1.0] * 8, device=dev), "fig7")
    want = exact_single_provider(works, 4.0, [1.0] * 8)
    rel = np.abs(res["completion"] - want) / want
    assert rel.max() < 1e-3, ("fig7", res["completion"], want)
    out["fig7_cpu_sharing"] = dict(rec, completion_s=res["completion"].tolist(),
                                   exact_s=want.tolist(),
                                   max_rel_err=float(rel.max()))
    fig8 = {}
    for label, pl in (("uncorrected", 1.0), ("corrected", 0.896)):
        res, rec = both(lambda dev: SharingProblem.build(
            perf=[4.0], provider=[0] * 4, consumer=[0] * 4,
            amount=works[:4], limit=[pl] * 4, device=dev), f"fig8 {label}")
        fig8[label] = dict(rec, completion_s=res["completion"].tolist())
    unc = np.asarray(fig8["uncorrected"]["completion_s"])
    meas = np.asarray(fig8["corrected"]["completion_s"])
    assert np.all(unc <= meas + 1e-6), ("fig8", unc, meas)
    out["fig8_memory_corrected"] = dict(
        fig8, uncorrected_vs_corrected_err=float(
            np.abs(unc - meas).max() / meas.max()))

    def fig9(dev):
        topo = make_topology(in_bw=[1000.0, 51.2, 1000.0, 25.6, 32.0],
                             out_bw=[64.0, 1000.0, 38.4, 1000.0, 1000.0],
                             latency=0.0, device=dev)
        return transfers_problem(topo, src=[0, 0, 2, 2], dst=[1, 3, 3, 4],
                                 size_mb=[768.0] * 4)

    res, rec = both(fig9, "fig9")
    want = np.array([768 / 51.2, 768 / 12.8, 768 / 12.8, 768 / 25.6])
    rel = np.abs(res["completion"] - want) / want
    assert rel.max() < 1e-3, ("fig9", res["completion"], want)
    out["fig9_network_bottleneck"] = dict(
        rec, transfer_s=res["completion"].tolist(), expected_s=want.tolist(),
        max_rel_err=float(rel.max()))

    spec, base = engine.make_cloud(n_pm=1, n_vm=8, pm_cores=8.0,
                                   perf_core=1.0, image_mb=0.001,
                                   boot_work=1e-4, latency_s=1e-4)
    arrivals = np.arange(8, dtype=np.float32) * 30.0
    trace = engine.Trace(arrival=arrivals, cores=np.ones(8, np.float32),
                         work=np.full(8, 600.0, np.float32))
    p_min, p_max = FIG12["p_min"], FIG12["p_max"]
    derate = (1.0, 0.9, 0.8, 0.7)
    params = engine.stack_params([
        dataclasses.replace(base, power=PowerStateTable.simple(
            max_w=p_min + d * (p_max - p_min))) for d in derate])
    runs = {}
    for dev in (device, "cpu"):
        res, wall, launches = _counted(lambda: engine.simulate_batch(
            spec, trace, params, device=dev), dev)
        runs[dev] = (_flat(res, spec), wall, launches)
    card, cpu = runs[device][0], runs["cpu"][0]
    # the whole-IaaS reading less the VMs' sum: a difference of two
    # readings of about 5e5 J, held to the tolerance of its operands
    key = "readings.vm_unattributed"
    np.testing.assert_allclose(
        card[key], cpu[key], rtol=0.0,
        atol=RTOL * float(np.abs(cpu["readings.iaas_total"]).max()),
        err_msg=f"fig10 card vs cpu: {key}")
    _assert_close("fig10 card vs cpu",
                  {k: v for k, v in card.items() if k != key},
                  {k: v for k, v in cpu.items() if k != key})
    flat, wall, launches = runs[device]
    got = float(flat["energy"][0].sum())
    t_end = float(flat["t_end"][0])
    want = staircase_energy(arrivals, 600.0, t_end, p_min, p_max, 8)
    rel = abs(got - want) / want
    assert rel < 0.02, ("fig10", got, want)
    if device == "cuda":
        assert launches["maxmin_solve"] == int(flat["n_events"].max()), (
            "fig10", launches)
    out["fig10_power_staircase"] = dict(
        events=flat["n_events"].astype(int).tolist(), wall_s=wall,
        cpu_wall_s=runs["cpu"][1], launches=launches, energy_j=got,
        expected_j=want, rel_err=rel, makespan_s=t_end,
        pmax_derate_sweep=list(derate),
        sweep_energy_j=flat["energy"].sum(-1).tolist())
    print(json.dumps({"sharing_validation": out}))
    return out


def _solve_record(dargs, iters: int = 64) -> dict:
    """The solve on one pass's inputs (``maxmin_solve`` argument tensors on
    the card): bit-equal to the CPU plain version, its times, the bound of
    the work it needs (as in :func:`_solve_work`), the plain version's
    time."""
    from repro_torch.kernels import maxmin
    got = maxmin.maxmin_solve(*dargs, max_iters=iters)
    torch.cuda.synchronize()
    want = maxmin.maxmin_solve_plain(*(x.cpu() for x in dargs),
                                     max_iters=iters)
    g, w = got.cpu().numpy(), want.numpy()
    assert np.array_equal(g.view(np.uint32), w.view(np.uint32)), (
        "maxmin_solve: not bit-equal to the CPU plain version at "
        f"C={dargs[0].shape[-1]} (max abs err {max_abs_err(g, w)})")
    n_bytes, n_ops, per_lane = _solve_work(dargs, iters)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    live, rounds = per_lane[0]
    return dict(
        shape=f"C={dargs[0].shape[-1]} S={dargs[4].shape[-1]} live={live} "
              f"rounds={rounds}",
        live=live, rounds=rounds, max_abs_err=max_abs_err(g, w),
        ms=time_ms(lambda: maxmin.maxmin_solve(*dargs), n=30, warmup=3),
        device_ms=graph_ms(lambda: maxmin.maxmin_solve(*dargs), n=20),
        host_us=host_us(lambda: maxmin.maxmin_solve(*dargs), n=200, reps=3),
        plain_ms=time_ms(lambda: maxmin.maxmin_solve_plain(*dargs), n=5,
                         warmup=1),
        bytes=n_bytes, ops=n_ops, bound_ms=b_ms, bound_by=b_by)


def sharing_fig12(device: str = "cuda") -> dict:
    """The Fig. 11/12 synthetic load at the largest parallelism
    (``FIG12``): single-core tasks (p_l = 1) as consumptions of one
    spreader (provider = consumer = 0, the Fig. 7 construction) of
    capacity 2,500 units/s, so up to four times more tasks compete than it
    serves at full speed, with Table 1's linear power model.  Every
    completion and the energy within rtol 1e-3 of the float64 closed form;
    events/s (host clock ending in a synchronize), launches a pass; on the
    card a profiled slice of the first SHARING_PROFILE_PASSES passes
    (launches and host reads a pass, device idle share and time by
    kernel), and the solve and the power term's segment sum timed on the
    busiest pass's inputs (rebuilt from the closed form)."""
    from repro_torch.core.arrays import segment_sum
    from repro_torch.core.sharing import SharingProblem, run_sharing
    from repro_torch.core.trace import synthetic_trace

    n, par, cap = FIG12["tasks"], FIG12["parallel"], FIG12["capacity"]
    tr = synthetic_trace(n, par, spread_s=10.0, length_range=(10.0, 90.0),
                         seed=par)
    p_idle, p_span = FIG12["p_min"], FIG12["p_max"] - FIG12["p_min"]
    prob = SharingProblem.build(perf=[cap], provider=np.zeros(n, np.int32),
                                consumer=np.zeros(n, np.int32),
                                amount=tr.work, limit=np.ones(n, np.float32),
                                t_start=tr.arrival, device=device)

    def go(**kw):
        return run_sharing(prob, p_idle=[p_idle], p_span=[p_span], **kw)

    res, wall, launches = _counted(go, device)
    flat = _sharing_flat(res)
    t0 = time.perf_counter()
    want, energy, peak = shared_spreader_closed_form(
        tr.arrival, tr.work, cap, p_idle, p_span)
    closed_s = time.perf_counter() - t0
    events = int(flat["n_events"])
    rel = np.abs(flat["completion"] - want) / want
    e_rel = abs(float(flat["energy"][0]) - energy) / energy
    rec = dict(tasks=n, parallel=par, capacity=cap, events=events,
               wall_s=wall, events_per_s=events / wall, launches=launches,
               launches_per_pass={k: v / events for k, v in launches.items()},
               peak_live=peak, max_rel_err_completion=float(rel.max()),
               energy_j=float(flat["energy"][0]), closed_form_energy_j=energy,
               energy_rel_err=e_rel, closed_form_s=closed_s,
               t_end=float(flat["t_end"]))
    print(json.dumps({"sharing_fig12": rec}))
    assert bool(flat["ok"]), "sharing_fig12: a task did not complete"
    assert rel.max() < 1e-3, ("sharing_fig12: completions", rel.max())
    assert e_rel < 1e-3, ("sharing_fig12: energy", e_rel)
    if device == "cuda":
        assert launches["maxmin_solve"] == events, launches
        _, prof = profiled(lambda: go(max_events=SHARING_PROFILE_PASSES))
        rec["profile"] = _per_pass(prof, SHARING_PROFILE_PASSES)
        print(json.dumps({"sharing_fig12_profile": rec["profile"]}))
        # the busiest pass: every task arrived and none done yet
        t_peak = float(np.max(np.asarray(tr.arrival)))
        live = torch.from_numpy((np.asarray(tr.arrival) <= t_peak)
                                & (want > t_peak)).to(device)
        dargs = (prob.provider, prob.consumer, prob.limit, live, prob.perf)
        rec["busiest_pass_solve"] = _solve_record(
            tuple(x[None].contiguous() for x in dargs))
        r = torch.where(live, torch.clamp(cap / live.sum(), max=1.0), 0.0)
        rec["busiest_pass_power_segment_sum_ms"] = time_ms(
            lambda: segment_sum(r[None], prob.provider[None], 1,
                                where=live[None]), n=30, warmup=3)
        print(json.dumps({"sharing_fig12_busiest_pass": {
            "solve": rec["busiest_pass_solve"],
            "power_segment_sum_ms":
                rec["busiest_pass_power_segment_sum_ms"]}}))
    return rec


def _per_pass(prof: dict, passes: int) -> dict:
    """A profiled run's summary with its launches and reads a pass."""
    keep = {k: v for k, v in prof.items()
            if k not in PROFILE_BULK}
    return dict(keep, passes=passes,
                kernel_launches_per_pass=prof["kernel_launches"] / passes,
                host_reads_per_pass=prof["host_reads"] / passes)


def network_inputs(n_nodes: int, n_transfers: int, window_s: float,
                   seed: int) -> dict:
    """A random network from ``seed``: in and out bandwidths drawn from
    NETWORK_BW, latencies uniform in 1-50 ms, transfers between distinct
    nodes of 100-1000 MB registered uniformly over ``window_s``, every
    10th capped at ROUTE_CAP by a router on its route."""
    rng = np.random.RandomState(seed)
    bw = np.asarray(NETWORK_BW, np.float32)
    topo = dict(in_bw=rng.choice(bw, n_nodes), out_bw=rng.choice(bw, n_nodes),
                latency=rng.uniform(0.001, 0.050, (n_nodes, n_nodes)).astype(
                    np.float32))
    src = rng.randint(0, n_nodes, n_transfers)
    dst = (src + rng.randint(1, n_nodes, n_transfers)) % n_nodes
    cap = np.full(n_transfers, 3e38, np.float32)
    cap[::10] = ROUTE_CAP
    transfers = dict(src=src.astype(np.int32), dst=dst.astype(np.int32),
                     size_mb=rng.uniform(100.0, 1000.0, n_transfers).astype(
                         np.float32),
                     t_register=rng.uniform(0.0, window_s, n_transfers)
                     .astype(np.float32),
                     route_cap=cap)
    return dict(topo=topo, transfers=transfers)


def _network_run(cell: str, device: str) -> tuple:
    """The network cell's problem on ``device``, run once with the
    counters set to 0 just before and read just after."""
    from repro_torch.core.network import make_topology, transfers_problem
    from repro_torch.core.sharing import run_sharing
    net = network_inputs(*NETWORK_CELLS[cell])
    prob = transfers_problem(make_topology(**net["topo"], device=device),
                             **net["transfers"])
    res, wall, launches = _counted(lambda: _sharing_flat(run_sharing(prob)),
                                   device)
    return net, prob, res, wall, launches


def network_full_width(device: str = "cuda") -> dict:
    """1,000 nodes (S = 2,000), 5,000 transfers over 600 s: every transfer
    done, each out-spreader's processed work the sum of its transfers'
    sizes (rtol 1e-5), each completion no earlier than its registration,
    latency and size over its narrowest rate (rtol 1e-5); events/s,
    launches a pass, and on the card a profiled slice of the first
    SHARING_PROFILE_PASSES passes."""
    from repro_torch.core.sharing import run_sharing

    cell = "network_full_width"
    net, prob, res, wall, launches = _network_run(cell, device)
    topo, tf = net["topo"], net["transfers"]
    events = int(res["n_events"])
    n_nodes = len(topo["in_bw"])
    sent = np.bincount(tf["src"], tf["size_mb"].astype(np.float64),
                       minlength=n_nodes)
    lat = topo["latency"][tf["src"], tf["dst"]].astype(np.float64)
    rate = np.minimum(np.minimum(topo["out_bw"][tf["src"]],
                                 topo["in_bw"][tf["dst"]]), tf["route_cap"])
    lower = tf["t_register"] + lat + tf["size_mb"] / rate.astype(np.float64)
    rec = dict(nodes=n_nodes, spreaders=2 * n_nodes,
               transfers=len(tf["size_mb"]), events=events, wall_s=wall,
               events_per_s=events / wall, launches=launches,
               launches_per_pass={k: v / events for k, v in launches.items()},
               t_end=float(res["t_end"]),
               min_slack=float((res["completion"] / lower).min()))
    print(json.dumps({cell: rec}))
    assert bool(res["ok"]), f"{cell}: a transfer did not complete"
    np.testing.assert_allclose(res["processed"][0::2], sent, rtol=1e-5,
                               err_msg=f"{cell}: out-spreader work")
    assert not res["processed"][1::2].any(), f"{cell}: in-spreader work"
    assert (res["completion"] >= lower * (1 - 1e-5)).all(), (
        f"{cell}: a transfer beat its narrowest rate")
    if device == "cuda":
        assert launches["maxmin_solve"] == events, launches
        _, prof = profiled(lambda: run_sharing(
            prob, max_events=SHARING_PROFILE_PASSES))
        rec["profile"] = _per_pass(prof, SHARING_PROFILE_PASSES)
        print(json.dumps({f"{cell}_profile": rec["profile"]}))
    return rec


def network_cross_check(cell: str = "network_cross_check",
                        device: str = "cuda") -> dict:
    """A network cell twice on ``device`` (bit-identical in every leaf) and
    once on the CPU (events exact, floats within RTOL / ATOL); above the
    gate the card's second run is profiled (launches, host reads and
    fill_round rounds a pass)."""
    from repro_torch.core.sharing import run_sharing
    from repro_torch.kernels import maxmin

    _, prob, a, wall_a, launches = _network_run(cell, device)
    above = not maxmin.solve_fits(prob.amount.shape[0], prob.perf.shape[0])
    if device == "cuda" and above:
        (b, wall_b), prof = profiled(lambda: timed_call(
            lambda: _sharing_flat(run_sharing(prob)), device))
    else:
        b, wall_b, _ = _counted(lambda: _sharing_flat(run_sharing(prob)),
                                device)
        prof = None
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), (
            f"{cell}: two runs on {device} differ in {k}")
    _, _, c, wall_c, _ = _network_run(cell, "cpu")
    _sharing_close(cell, a, c)
    events = int(a["n_events"])
    rec = dict(spreaders=int(prob.perf.shape[0]),
               transfers=int(prob.amount.shape[0]), above_gate=above,
               events=events, card_wall_s=[wall_a, wall_b],
               events_per_s=events / wall_a, cpu_wall_s=wall_c,
               launches=launches,
               launches_per_pass={k: v / events for k, v in launches.items()},
               leaves_bit_equal_card_cpu=sum(
                   a[k].tobytes() == c[k].tobytes() for k in a))
    if prof is not None:
        rec["profile"] = _per_pass(prof, events)
    print(json.dumps({cell: rec}))
    assert bool(a["ok"]), f"{cell}: a transfer did not complete"
    if device == "cuda":
        if above:
            assert launches["maxmin_solve"] == 0, launches
            assert launches["fill_stats"] > 0 and launches["fill_plan"] > 0, (
                launches)
        else:
            assert launches["maxmin_solve"] == events, launches
    return rec


def cloud_facade(mono: dict, device: str = "cuda", n_pm: int = 20,
                 n_vm: int = 1024) -> dict:
    """The cross-check cell (alwayson, bucket 128), stopped at half of its
    end time (``mono``: the card run's leaves) on the card and on the CPU:
    ``cloud_info`` equal (integers and names exact, floats within RTOL /
    ATOL); then ``deregister_pm(pm=0)`` and a resumed ``simulate(...,
    state=st)``: events, task states and every leaf equal card against
    CPU within tolerance, every task done or rejected; and the
    ``state_change_events`` of both steps equal."""
    from repro_torch.core import cloud, engine
    from repro_torch.core.loop.state import TASK_DONE, TASK_REJECTED
    from repro_torch.core.trace import filter_fitting, gwa_like_trace

    trace = filter_fitting(gwa_like_trace("das2", 200, seed=7), 64.0)
    spec, params = engine.make_cloud(n_pm=n_pm, n_vm=n_vm, pm_cores=64.0,
                                     pm_sched="alwayson", compact=128,
                                     max_events=4_000_000)
    t_half = float(mono["t_end"]) / 2
    out = {}
    for dev in (device, "cpu"):
        first, wall1, launches = _counted(lambda: engine.simulate(
            spec, trace, params, t_stop=t_half, device=dev), dev)
        info = cloud.cloud_info(spec, params, first.state, trace)
        st = cloud.deregister_pm(spec, params, first.state, 0, trace)
        after, wall2, launches2 = _counted(lambda: engine.simulate(
            spec, trace, params, state=st, device=dev), dev)
        out[dev] = dict(
            info=info, flat=_flat(after, spec), wall_s=[wall1, wall2],
            launches=[launches, launches2],
            events=(cloud.state_change_events(first.state, st),
                    cloud.state_change_events(st, after.state)),
            task_state=after.state.task_state.cpu().numpy())
    card, cpu = out[device], out["cpu"]
    for k, w in cpu["info"].items():
        g = card["info"][k]
        if isinstance(w, (str, int)) or k == "pm_vm_count":
            assert g == w, ("cloud_facade: cloud_info", k, g, w)
        elif k == "meters":
            for m in w:
                np.testing.assert_allclose(g[m], w[m], rtol=RTOL, atol=ATOL,
                                           err_msg=f"cloud_facade {m}")
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"cloud_facade {k}")
    _assert_close("cloud_facade resumed card vs cpu", card["flat"],
                  cpu["flat"])
    assert card["events"] == cpu["events"], "cloud_facade: state changes"
    ts = card["task_state"]
    assert ((ts == TASK_DONE) | (ts == TASK_REJECTED)).all(), (
        "cloud_facade: a task neither done nor rejected after the resume")
    info = card["info"]
    rec = dict(t_stop=t_half, info={k: info[k] for k in (
        "pm_running", "vm_hosted", "queue_len", "tasks_done",
        "tasks_active", "capacity_allocated_cores", "energy_joules",
        "vm_scheduler", "pm_scheduler")},
        killed_vms=len(card["events"][0]["vm_transitions"]),
        resumed_events=int(card["flat"]["n_events"]),
        tasks_completed_after=card["events"][1]["tasks_completed"],
        card_wall_s=card["wall_s"], cpu_wall_s=cpu["wall_s"],
        launches=card["launches"])
    print(json.dumps({"cloud_facade": rec}))
    assert rec["killed_vms"] > 0, "cloud_facade: PM 0 hosted no VM"
    return rec


# ---------------------------------------------------------------------------
# LM stack: flash_attention and linear_scan, the Jamba hybrid end to end
# ---------------------------------------------------------------------------

LM_ARCH = "jamba-v0.1-52b"
# flash kernel against its plain version, (rtol, atol).  Both compute in f32
# and round the output once, so in bf16 they differ by at most one ulp,
# 2**-7 of the value at most: rtol 1e-2 covers it and atol 2e-3 the
# smallest outputs.  At the main path's shape an output's spread is about
# 0.03, so a wrong scale or a dropped or extra tile of keys breaks this.
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-2, 2e-3)}
# the 8-layer model in bf16, flash kernel against the chunked path: the two
# sum the attention in another order before rounding it to bf16, and later
# layers carry the difference (a near-tie in MoE routing may flip a token),
# so the check bounds the relative L2 error of the logits and the share of
# positions whose argmax agrees
LM_REL_L2_TOL, LM_ARGMAX_AGREE = 1e-2, 0.95
LM_CROSS_TOL = 1e-4        # reduced config in f32, card vs CPU


def visible_pairs(Tq, Tk, *, causal=True, window=0, prefix_len=0,
                  q_offset=0) -> int:
    """(query, key) pairs the mask lets through, per (batch, head)."""
    qp = np.arange(Tq)[:, None] + q_offset
    kp = np.arange(Tk)[None, :]
    m = np.ones((Tq, Tk), bool)
    if causal:
        m = kp <= qp
        if window > 0:
            m = m & (kp > qp - window)
        if prefix_len > 0:
            m = m | (kp < prefix_len)
    return int(m.sum())


def _randn(shapes, dtype, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(s, generator=g, device=dev).to(dtype)
                 for s in shapes)


FLASH_CASES = [   # (B, Tq, Tk, Hq, Hkv, D, options)
    (1, 16, 16, 2, 2, 8, dict(causal=True)),
    (2, 33, 33, 4, 2, 16, dict(causal=True)),                  # GQA, pad
    (1, 64, 64, 2, 1, 32, dict(causal=True, window=16)),       # local
    (1, 48, 48, 2, 2, 16, dict(causal=True, softcap=30.0)),    # gemma2
    (1, 40, 40, 2, 1, 16, dict(causal=True, prefix_len=8)),    # vlm
    (2, 24, 24, 2, 2, 8, dict(causal=False)),                  # encoder
    (1, 384, 384, 2, 2, 16, dict(causal=True, prefix_len=256)),
    (2, 20, 50, 4, 2, 16, dict(causal=True, q_offset=30)),
    (1, 200, 200, 8, 2, 128, dict(causal=True, window=70, softcap=20.0)),
    (1, 130, 130, 4, 4, 256, dict(causal=True)),
    (1, 65, 97, 4, 1, 50, dict(causal=False)),                 # D % 4 != 0
    (2, 70, 70, 8, 2, 6, dict(causal=True, q_offset=5)),
    (1, 300, 300, 32, 8, 128, dict(causal=True)),              # Jamba heads
]
SCAN_CASES = [    # (B, T, D, a dtype, x dtype, with h0)
    (2, 13, 40, torch.float32, torch.float32, True),
    (1, 1, 7, torch.float32, torch.float32, True),
    (3, 256, 130, torch.float32, torch.float32, False),
    (2, 300, 33, torch.float32, torch.bfloat16, True),
    (2, 17, 24, torch.bfloat16, torch.bfloat16, False),
    (1, 5, 1000, torch.bfloat16, torch.float32, True),
]
SCAN_FULL = ((4, 256, 131072), (1, 256, 131072), (4, 1, 131072))


def _scan_inputs(B, T, D, a_dtype, x_dtype, with_h0, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = (0.5 + 0.5 * torch.rand((B, T, D), generator=g, device=dev))
    x = torch.randn((B, T, D), generator=g, device=dev)
    h0 = (torch.randn((B, D), generator=g, device=dev) if with_h0
          else None)
    return a.to(a_dtype), x.to(x_dtype), h0


def lm_kernel_phase(dev) -> tuple[dict, dict]:
    """flash_attention and linear_scan against their plain versions on
    random cases covering every feature, then at the full-width shapes of
    the Jamba hybrid, timed beside the plain version and the library."""
    from repro_torch.kernels import attention as kattn
    from repro_torch.kernels import ssm as kssm

    records, checks = {}, {}
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_mma = 0
    for i, (B, Tq, Tk, Hq, Hkv, D, kw) in enumerate(FLASH_CASES):
        for dtype in errs:
            var = kattn.variant(dtype, D)
            q, k, v = _randn(((B, Tq, Hq, D), (B, Tk, Hkv, D),
                              (B, Tk, Hkv, D)), dtype, i, dev)
            mma0 = kattn.flash_attention.mma_launches
            got = kattn.flash_attention(q, k, v, **kw).float().cpu()
            went_mma = kattn.flash_attention.mma_launches - mma0
            assert went_mma == (dtype == torch.bfloat16) == (
                var.name == "mma"), ("flash variant", i, dtype, went_mma)
            n_mma += went_mma
            want = kattn.flash_attention_plain(q, k, v, **kw).float().cpu()
            rtol, atol = FLASH_TOL[dtype]
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                                       atol=atol,
                                       err_msg=f"flash {dtype} {i} {kw}")
            errs[dtype] = max(errs[dtype], max_abs_err(got, want))
            # each variant's tile skip against the host's count
            vis = torch.empty(B * Hq * -(-Tq // var.bq), dtype=torch.int32,
                              device=dev)
            kattn.flash_attention(q, k, v, visited=vis, **kw)
            plan = B * Hq * kattn.visited_tiles(Tq, Tk, bq=var.bq, bk=var.bk,
                                                **{o: kw[o] for o in (
                                                    "causal", "window",
                                                    "prefix_len", "q_offset")
                                                   if o in kw})
            assert int(vis.sum()) == plan, ("visited tiles", i, str(dtype),
                                            int(vis.sum()), plan)
    assert n_mma == len(FLASH_CASES)
    checks["flash_cases"] = 2 * len(FLASH_CASES)
    checks["flash_cases_bf16_on_tensor_cores"] = n_mma
    checks["flash_cases_max_abs_err"] = {str(k): v for k, v in errs.items()}
    checks["flash_tol_rtol_atol"] = {str(k): v for k, v in FLASH_TOL.items()}

    # the Jamba forward's attention: B=1, T=4096, 32/8 heads, D=128, bf16
    B, T, Hq, Hkv, D = 1, 4096, 32, 8, 128
    var = kattn.variant(torch.bfloat16, D)
    q, k, v = _randn(((B, T, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D)),
                     torch.bfloat16, 99, dev)
    mma0 = kattn.flash_attention.mma_launches
    got = kattn.flash_attention(q, k, v)
    again = kattn.flash_attention(q, k, v)
    assert kattn.flash_attention.mma_launches - mma0 == 2, (
        "full-width flash_attention did not run on the tensor cores")
    want = kattn.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(got, again), "flash_attention differs between launches"
    rtol, atol = FLASH_TOL[torch.bfloat16]
    err_full = max_abs_err(got.float().cpu(), want.float().cpu())
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=atol, err_msg="flash full width")
    checks["flash_full_width_max_abs_err"] = err_full
    del want
    vis = torch.empty(B * Hq * (T // var.bq), dtype=torch.int32,
                      device=dev)
    kattn.flash_attention(q, k, v, visited=vis)
    assert int(vis.sum()) == B * Hq * kattn.visited_tiles(
        T, T, bq=var.bq, bk=var.bk), "full-width visited tiles"
    checks["flash_full_width_tiles_visited_share"] = int(vis.sum()) / (
        B * Hq * (T // var.bq) * (T // var.bk))
    checks["flash_full_width_bit_identical"] = True
    # the library yardstick: PyTorch's fused attention, KV heads expanded
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2)
              .contiguous() for t in (k, v))
    lib = sdpa(qt, kt, vt, is_causal=True).transpose(1, 2)
    checks["flash_full_width_vs_sdpa_max_abs_err"] = max_abs_err(
        got.float().cpu(), lib.float().cpu())
    flops = 4 * D * B * Hq * visible_pairs(T, T)
    n_bytes = q.nbytes + k.nbytes + v.nbytes + got.nbytes
    records["flash_attention"] = dict(
        shape=f"B={B} T={T} Hq={Hq} Hkv={Hkv} D={D} bf16 causal",
        variant=f"{var.name} (BQ={var.bq}, BK={var.bk})",
        max_abs_err=max(err_full, *errs.values()),
        max_abs_err_full_width=err_full,
        max_abs_err_vs_sdpa=checks["flash_full_width_vs_sdpa_max_abs_err"],
        ms=time_ms(lambda: kattn.flash_attention(q, k, v), n=30, warmup=3),
        plain_ms=time_ms(lambda: kattn.flash_attention_plain(q, k, v),
                         n=10, warmup=2),
        library_ms=time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), n=30,
                           warmup=3),
        device_ms=graph_ms(lambda: kattn.flash_attention(q, k, v), n=10),
        host_us=host_us(lambda: kattn.flash_attention(q, k, v), n=100,
                        reps=3),
        bytes=n_bytes, ops=flops, ops_per_s=H100_BF16_OPS_PER_S,
        bound_ms_f32=bound_ms(n_bytes, flops)[0])
    del q, k, v, qt, kt, vt, got, again, lib

    # ---- linear_scan: bit-equal to the plain version everywhere ----------
    for i, (B, T, D, adt, xdt, with_h0) in enumerate(SCAN_CASES):
        a, x, h0 = _scan_inputs(B, T, D, adt, xdt, with_h0, i, dev)
        y, h = kssm.linear_scan(a, x, h0)
        wy, wh = kssm.linear_scan_plain(a, x, h0)
        cy, ch = kssm.linear_scan_plain(
            a.cpu(), x.cpu(), None if h0 is None else h0.cpu())
        assert y.dtype == xdt and h.dtype == torch.float32
        assert torch.equal(y, wy) and torch.equal(h, wh), (
            f"linear_scan case {i}: not bit-equal to its plain version")
        assert torch.equal(y.cpu(), cy) and torch.equal(h.cpu(), ch), (
            f"linear_scan case {i}: not bit-equal to the CPU plain version")
    checks["scan_cases_bit_equal"] = len(SCAN_CASES)
    times = {}
    for B, T, D in SCAN_FULL:
        a, x, h0 = _scan_inputs(B, T, D, torch.float32, torch.float32, True,
                                T, dev)
        y, h = kssm.linear_scan(a, x, h0)
        wy, wh = kssm.linear_scan_plain(a, x, h0)
        assert torch.equal(y, wy) and torch.equal(h, wh), (
            f"linear_scan {(B, T, D)}: not bit-equal to its plain version")
        n_bytes = a.nbytes + x.nbytes + y.nbytes + h0.nbytes + h.nbytes
        times[f"{B}x{T}x{D}"] = dict(
            ms=time_ms(lambda: kssm.linear_scan(a, x, h0), n=50),
            device_ms=graph_ms(lambda: kssm.linear_scan(a, x, h0), n=10),
            host_us=host_us(lambda: kssm.linear_scan(a, x, h0), n=100,
                            reps=3),
            plain_ms=time_ms(lambda: kssm.linear_scan_plain(a, x, h0), n=10,
                             warmup=2),
            bytes=n_bytes, ops=2 * B * T * D,
            bound_ms=bound_ms(n_bytes, 2 * B * T * D)[0])
        del a, x, h0, y, h, wy, wh
    checks["scan_full_width"] = times
    main = times["4x256x131072"]
    records["linear_scan"] = dict(
        shape="B=4 T=256 D=131072 f32 (one prefill chunk of lm_serve; "
              "decode steps are 4x1x131072)",
        max_abs_err=0.0, ms=main["ms"], plain_ms=main["plain_ms"],
        device_ms=main["device_ms"], host_us=main["host_us"],
        library_ms=None, bytes=main["bytes"], ops=main["ops"])
    torch.cuda.empty_cache()
    return records, checks


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _forward_record(cfg, params, batch) -> tuple:
    """One timed lm.forward on the card with the launch counters set to 0
    just before and read just after."""
    from repro_torch import kernels
    from repro_torch.models import lm

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    logits, _ = lm.forward(cfg, params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return logits, wall, dict(kernels.launch_counts(),
                              **kernels.sub_launch_counts())


def _serve(cfg, params, prompts, max_new, max_len, device, timers=None):
    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(cfg, params, batch_size=len(prompts), max_len=max_len,
                      eos_id=-1, device=device)
    if timers is not None:
        def timed(name, fn):
            def call(*args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                timers[name].append(time.perf_counter() - t0)
                return out
            return call
        eng._prefill = timed("prefill", eng._prefill)
        eng._decode = timed("decode", eng._decode)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=max_new))
    stats = eng.run()
    return [r.output for r in sorted(eng.done, key=lambda r: r.rid)], stats


def lm_phase(dev) -> dict:
    """The Jamba hybrid at full width (16 of its 32 layers: 32 take ~103 GB
    in bf16): forward and serve with launch counts, the kernel path against
    the reference's plain path, and the reduced config card vs CPU."""
    from repro_torch import configs, kernels
    from repro_torch.models import common as cm
    from repro_torch.models import lm

    out = {}
    cfg = configs.get(LM_ARCH, n_layers=16, attn_impl="pallas")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    leaves = [t for _, t in cm.leaves(params)]
    model = dict(layers=cfg.n_layers, params=sum(t.numel() for t in leaves),
                 param_bytes=sum(t.nbytes for t in leaves),
                 init_s=time.perf_counter() - t0)
    del leaves
    print(json.dumps({"lm_model": model}))

    # ---- lm_forward_full_width: B=1, T=4096 ------------------------------
    T = 4096
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab, (1, T))).to(dev)
    # the entry point itself turns reduced-precision products off
    mm = torch.backends.cuda.matmul
    mm.allow_tf32 = mm.allow_bf16_reduced_precision_reduction = True
    # first call: cuBLAS plans
    _forward_record(cfg, params, {"tokens": tokens})
    assert not (mm.allow_tf32 or mm.allow_bf16_reduced_precision_reduction), (
        "lm.forward left reduced-precision products on")
    logits, wall, launches = _forward_record(cfg, params,
                                             {"tokens": tokens})
    rec = dict(batch=1, tokens=T, wall_s=wall, tokens_per_s=T / wall,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               launches=launches,
               logits_finite=bool(torch.isfinite(logits).all()),
               logits_std=float(logits.std()))
    print(json.dumps({"lm_forward_full_width": rec}))
    assert tuple(logits.shape) == (1, T, cfg.vocab), logits.shape
    assert rec["logits_finite"], "lm_forward_full_width: non-finite logits"
    n_attn = sum(ls.kind == "attn" for ls in lm.layer_kinds(cfg))
    n_mamba = cfg.n_layers - n_attn
    assert launches["flash_attention"] == n_attn == 2, launches
    assert launches["flash_attention_mma"] == 2, launches   # bf16 variant
    assert launches["linear_scan"] == n_mamba * T // cfg.scan_chunk == 224, (
        launches)
    out["lm_forward_full_width"] = rec
    del logits

    # ---- lm_serve_full_width: 4 prompts of 384-512 tokens, 32 new ---------
    rng = np.random.RandomState(2)
    lens = [512] + [int(n) for n in rng.randint(384, 513, 3)]
    prompts = [[int(t) for t in rng.randint(2, cfg.vocab, n)] for n in lens]
    _serve(cfg, params, [prompts[0][:16]], 2, 64, dev)   # warm-up
    timers = {"prefill": [], "decode": []}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    outs, stats = _serve(cfg, params, prompts, 32, 1024, dev, timers)
    launches = kernels.launch_counts()
    rec = dict(stats, prompt_lens=lens, new_tokens=32,
               prefill_s=timers["prefill"][0],
               decode_ms_per_step=1e3 * statistics.median(timers["decode"]),
               decode_steps=len(timers["decode"]),
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               launches=launches, first_tokens=[o[:4] for o in outs])
    print(json.dumps({"lm_serve_full_width": rec}))
    assert all(len(o) == 32 and all(0 <= t < cfg.vocab for t in o)
               for o in outs), "lm_serve_full_width: bad outputs"
    assert launches["linear_scan"] == n_mamba * (2 + 31) == 462, launches
    assert launches["flash_attention"] == 0, launches
    out["lm_serve_full_width"] = rec

    # ---- where the time goes: one forward, one serve batch, profiled -----
    _, prof_f = profiled(lambda: lm.forward(cfg, params, {"tokens": tokens}))
    _, prof_s = profiled(lambda: _serve(cfg, params, prompts, 32, 1024, dev))
    out["lm_profile"] = dict(forward=prof_f, serve=prof_s)
    print(json.dumps({"lm_profile": {
        k: {x: y for x, y in v.items()
            if x not in PROFILE_BULK}
        for k, v in out["lm_profile"].items()}}))

    # ---- lm_kernel_vs_plain: first 8 layers, pallas against chunked ------
    rec = _family_vs_plain(LM_ARCH, cfg, params, {"tokens": tokens[:, :1024]},
                           layers=8)
    assert rec["launches_kernels"]["linear_scan"] == (
        7 * 1024 // cfg.scan_chunk), rec["launches_kernels"]
    assert rec["launches_plain"]["linear_scan"] == 0, rec["launches_plain"]
    cfg8, params8 = _first_layers(cfg, params, 8)
    sprompts = [[int(t) for t in rng.randint(2, cfg.vocab, n)]
                for n in (100, 160, 130, 200)]
    tok_k, _ = _serve(cfg8, params8, sprompts, 8, 256, dev)
    tok_p, _ = _serve(dataclasses.replace(cfg8, attn_impl="chunked"), params8,
                      sprompts, 8, 256, dev)
    rec["serve_tokens_equal"] = tok_k == tok_p
    print(json.dumps({"lm_kernel_vs_plain": rec}))
    assert tok_k == tok_p, "lm_kernel_vs_plain: greedy tokens differ"
    out["lm_kernel_vs_plain"] = rec
    del params, params8
    torch.cuda.empty_cache()

    # ---- lm_cross_check: reduced config in f32, card against CPU ---------
    rec = _family_cross_check(LM_ARCH, dev)
    print(json.dumps({"lm_cross_check": rec}))
    assert rec["launches"]["linear_scan"] > 0, rec["launches"]
    out["lm_cross_check"] = rec
    out["lm_model"] = model
    return out


# ---------------------------------------------------------------------------
# LM stack: the nine other architectures at their published widths
# ---------------------------------------------------------------------------

# arch -> layers run (of the published depth), decoder tokens, the VLM's
# patch prefix, the enc-dec source frames, and the flash launches of one
# forward (every attention layer; seamless: 24 encoder, 24 causal, 24
# cross).  Each runs at its published depth where that fits: else at the
# most whole repeats of its layer pattern whose weights, beside the
# forward's activations (measured at 8 layers on an H100: gemma2 25.3 GB
# at 8192 tokens, command-r 10.6 GB, phi3.5-moe 1.4 GB), take at most 64
# GB of the card's 80, which leaves room for the second set of logits
# that the kernel-against-plain comparison holds (PERF.md §4).
LM_FAMILIES = {
    "gemma2-27b": dict(layers=32, T=8192, flash=32),  # T > window: it masks
    "command-r-35b": dict(layers=34, T=4096, flash=34),
    "codeqwen1.5-7b": dict(layers=32, T=4096, flash=32),
    "granite-3-2b": dict(layers=40, T=4096, flash=40),
    "granite-moe-1b-a400m": dict(layers=24, T=4096, flash=24),
    "phi3.5-moe-42b-a6.6b": dict(layers=23, T=4096, flash=23),
    "rwkv6-3b": dict(layers=32, T=2048, flash=0),
    "seamless-m4t-large-v2": dict(layers=24, T=512, frames=1024, flash=72),
    "paligemma-3b": dict(layers=18, T=768, patches=256, flash=18),
}
FAMILY_NEW_TOKENS = 8
FAMILY_PROMPTS = 3            # prompts of 100-500 tokens in a serve batch
# query rows of a flash launch held against the plain version: the first
# and the last FLASH_CHECK_ROWS (the plain version holds the whole f32
# score matrix of the rows it computes)
FLASH_CHECK_ROWS = 256


def _family_inputs(cfg, spec: dict, dev, seed: int, B: int = 1,
                   T: int | None = None) -> dict:
    """Tokens, and the patches or frames (randn, from ``seed``) the family
    reads, on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    T = spec["T"] if T is None else T
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, T), generator=g,
                                     device=dev)}
    for key in ("patches", "frames"):
        if key in spec:
            batch[key] = torch.randn((B, spec[key], cfg.d_model), generator=g,
                                     device=dev).to(cfg.cdtype)
    return batch


def _flash_per_forward(cfg) -> int:
    """flash_attention launches of one lm.forward with attn_impl "pallas":
    one per attention layer, and for the enc-dec config one per encoder
    layer and per cross-attention sub-block too."""
    from repro_torch.models import lm

    n_attn = sum(ls.kind == "attn" for ls in lm.layer_kinds(cfg))
    return n_attn * (1 + cfg.is_encdec) + cfg.enc_layers * cfg.is_encdec


def _plain_rows_err(kattn, q, k, v, out, kw) -> float:
    """A flash launch's output against the plain version on the same
    inputs (FLASH_TOL) at the first and the last FLASH_CHECK_ROWS query
    rows; the largest absolute difference."""
    Tq, n = q.shape[1], FLASH_CHECK_ROWS
    rows = ([(0, Tq)] if Tq <= 2 * n else [(0, n), (Tq - n, Tq)])
    rtol, atol = FLASH_TOL[q.dtype]
    err = 0.0
    for r0, r1 in rows:
        want = kattn.flash_attention_plain(
            q[:, r0:r1], k, v, **dict(kw, q_offset=kw["q_offset"] + r0))
        got, want = out[:, r0:r1].float().cpu(), want.float().cpu()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                                   atol=atol, err_msg=f"flash vs plain {kw}")
        err = max(err, max_abs_err(got, want))
    return err


class FlashVisits:
    """Within ``with``, every flash_attention launch of the models also
    fills a ``visited`` tensor; each launch's total is held against the
    host's count (``kernels.attention.visited_tiles``) and kept.  The first
    launch at each shape and mask is also held against the plain version
    on the same inputs (:func:`_plain_rows_err`); its error is kept.  The
    models see the kernel module through a stand-in, so the wrapper itself,
    and its launch counters, stay as they are."""

    def __enter__(self):
        from repro_torch.kernels import attention as kattn
        from repro_torch.models import attention as mattn

        self.mattn, self.seen = mattn, []
        checked = set()

        def recording(q, k, v, **kw):
            B, Tq, Hq, D = q.shape
            var = kattn.variant(q.dtype, D)
            vis = torch.zeros(B * Hq * -(-Tq // var.bq), dtype=torch.int32,
                              device=q.device)
            out = kattn.flash_attention(q, k, v, visited=vis, **kw)
            mask = {o: kw[o] for o in ("causal", "window", "prefix_len",
                                       "q_offset")}
            want = B * Hq * kattn.visited_tiles(Tq, k.shape[1], bq=var.bq,
                                                bk=var.bk, **mask)
            got = int(vis.sum())
            assert got == want, ("visited tiles", mask, got, want)
            rec = dict(mask, Tq=Tq, Tk=k.shape[1], visited=got)
            key = (tuple(q.shape), tuple(k.shape), q.dtype, kw["causal"],
                   kw["window"], kw["prefix_len"], kw["softcap"],
                   kw["scale"])
            if key not in checked:
                checked.add(key)
                rec["plain_max_abs_err"] = _plain_rows_err(kattn, q, k, v,
                                                           out, kw)
            self.seen.append(rec)
            return out

        class Module:
            flash_attention = staticmethod(recording)

            def __getattr__(self, name):
                return getattr(kattn, name)

        mattn.kattn = Module()
        return self.seen

    def __exit__(self, *exc):
        from repro_torch.kernels import attention as kattn

        self.mattn.kattn = kattn


def _pad_left(prompts, dev):
    toks = np.zeros((len(prompts), max(map(len, prompts))), np.int64)
    for i, p in enumerate(prompts):
        toks[i, toks.shape[1] - len(p):] = p
    return torch.from_numpy(toks).to(dev)


def _greedy(cfg, params, batch, new: int, max_len: int,
            forced=None) -> tuple:
    """The serving route of the enc-dec and VLM families: lm.prefill (with
    ``frames`` or ``patches``) and greedy lm.decode_step, the launch
    counters set to 0 just before and read just after; with ``forced``
    ([B, new] tokens), each step is fed those instead of its own argmax.
    Returns (tokens [B, new] and logits [B, new, vocab] on the host, wall
    s, launches)."""
    from repro_torch import kernels
    from repro_torch.models import lm

    dev = params["embed"].device
    enc_len = batch["frames"].shape[1] if "frames" in batch else 0
    _sync(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cache = lm.init_cache(cfg, batch["tokens"].shape[0], max_len,
                          enc_len=enc_len, device=dev)
    logits, cache = lm.prefill(cfg, params, batch, cache)
    steps = [logits]
    for i in range(new - 1):
        fed = (torch.argmax(logits, dim=-1) if forced is None
               else forced[:, i].to(dev))
        logits, cache = lm.decode_step(cfg, params, fed[:, None], cache)
        steps.append(logits)
    logits = torch.stack(steps, dim=1).float().cpu()
    wall = time.perf_counter() - t0
    return logits.argmax(-1), logits, wall, dict(
        kernels.launch_counts(), **kernels.sub_launch_counts())


def _first_layers(cfg, params, n: int) -> tuple:
    """The config and parameters of the first ``n`` layers of each stack
    (views of the stacked leaves)."""
    from repro_torch.models import common as cm
    from repro_torch.models import lm

    def cut(blocks, role, n_all):
        pattern, _ = lm.find_pattern(lm.layer_kinds(cfg, role=role,
                                                    n_layers=n_all))
        return [cm.tree_map(lambda _, t: t[:n // len(pattern)], b)
                for b in blocks]

    role = "xdecoder" if cfg.is_encdec else "decoder"
    sub = dict(params, blocks=cut(params["blocks"], role, cfg.n_layers))
    over = dict(n_layers=n)
    if cfg.is_encdec:
        sub["enc_blocks"] = cut(params["enc_blocks"], "encoder",
                                cfg.enc_layers)
        over["enc_layers"] = n
    return dataclasses.replace(cfg, **over), sub


def _serve_flash(cfg, new: int) -> int:
    """flash_attention launches of a prefill and ``new - 1`` decode steps:
    the cache path's self-attention is chunked (``kv_len`` is set); as in
    the reference, the encoder and the cross-attention take the kernel,
    once each in the prefill and the cross layers again at each step."""
    return cfg.enc_layers + cfg.n_layers * new if cfg.is_encdec else 0


def _agreement(got, want) -> dict:
    """Relative L2 error of ``got`` and the share of positions whose argmax
    agrees, against LM_REL_L2_TOL and LM_ARGMAX_AGREE."""
    rel = float((got - want).norm() / want.norm())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    return dict(rel_l2_err=rel, rel_l2_tol=LM_REL_L2_TOL, argmax_agree=agree,
                argmax_agree_min=LM_ARGMAX_AGREE,
                ok=rel <= LM_REL_L2_TOL and agree >= LM_ARGMAX_AGREE)


def _family_serve(arch, cfg, params, spec, rng) -> dict:
    """A short serve: FAMILY_PROMPTS prompts of 100-500 tokens,
    FAMILY_NEW_TOKENS greedy tokens each; ServeEngine for every family but
    the enc-dec one, which ServeEngine refuses; lm.prefill with frames and
    lm.decode_step for that one, and for the VLM too, with patches.  Where
    that route launches flash (the enc-dec encoder and cross-attention),
    each launch shape is held against the plain version and the logits of
    every step against attn_impl "chunked" fed the same tokens."""
    from repro_torch import kernels

    dev = params["embed"].device
    new = FAMILY_NEW_TOKENS
    lens = [int(n) for n in rng.randint(100, 501, FAMILY_PROMPTS)]
    prompts = [[int(t) for t in rng.randint(2, cfg.vocab, n)] for n in lens]
    rec = dict(prompt_lens=lens, new_tokens=new)
    max_len = max(lens) + new
    if not cfg.is_encdec:
        kernels.reset_launch_counts()
        outs, stats = _serve(cfg, params, prompts, new, max_len, dev)
        launches = dict(kernels.launch_counts(),
                        **kernels.sub_launch_counts())
        rec["engine"] = dict(stats, launches=launches,
                             first_tokens=[o[:4] for o in outs])
        assert all(len(o) == new and all(0 <= t < cfg.vocab for t in o)
                   for o in outs), (arch, "serve outputs")
        assert launches["flash_attention"] == 0, (arch, launches)
    if "patches" in spec or "frames" in spec:
        batch = _family_inputs(cfg, spec, dev, 5, B=FAMILY_PROMPTS, T=1)
        batch["tokens"] = _pad_left(prompts, dev)
        max_len += spec.get("patches", 0)
        want = _serve_flash(cfg, new)
        with FlashVisits() as seen:
            toks, logits, wall, launches = _greedy(cfg, params, batch, new,
                                                   max_len)
        rec["prefill_decode"] = dict(wall_s=wall, launches=launches,
                                     tokens_per_s=toks.numel() / wall,
                                     first_tokens=toks[:, :4].tolist())
        assert toks.shape == (FAMILY_PROMPTS, new), (arch, toks.shape)
        assert bool(((toks >= 0) & (toks < cfg.vocab)).all()), arch
        assert launches["flash_attention"] == launches[
            "flash_attention_mma"] == want == len(seen), (
            arch, launches, want, len(seen))
        if want:
            rec["prefill_decode"]["flash_vs_plain"] = [
                v for v in seen if "plain_max_abs_err" in v]
            _, lp, _, launch_p = _greedy(
                dataclasses.replace(cfg, attn_impl="chunked"), params, batch,
                new, max_len, forced=toks)
            rec["prefill_decode"]["vs_chunked"] = vs = _agreement(logits, lp)
            assert launch_p["flash_attention"] == 0, (arch, launch_p)
            assert vs["ok"], (arch, "prefill/decode vs chunked", vs)
    return rec


def _family_vs_plain(arch, cfg, params, batch, layers: int = 2) -> dict:
    """The first ``layers`` layers of each stack, attn_impl "pallas"
    against "chunked" (the reference's own plain path), on ``batch``."""
    cfg2, params2 = _first_layers(cfg, params, layers)
    lk, wall_k, launch_k = _forward_record(cfg2, params2, batch)
    lp, wall_p, launch_p = _forward_record(
        dataclasses.replace(cfg2, attn_impl="chunked"), params2, batch)
    rec = dict(layers=layers, tokens=batch["tokens"].shape[1],
               **_agreement(lk, lp), wall_s_kernels=wall_k,
               wall_s_plain=wall_p, launches_kernels=launch_k,
               launches_plain=launch_p)
    want = _flash_per_forward(cfg2)
    assert launch_k["flash_attention"] == launch_k[
        "flash_attention_mma"] == want, (arch, launch_k, want)
    assert launch_p["flash_attention"] == 0, (arch, launch_p)
    assert rec["ok"], (arch, "kernel vs plain", rec)
    return rec


def _family_cross_check(arch, dev) -> dict:
    """The reduced config in f32, the card against the CPU: logits within
    LM_CROSS_TOL and greedy tokens equal (ServeEngine, or for the enc-dec
    and VLM configs prefill with frames or patches and decode_step)."""
    from repro_torch import configs
    from repro_torch.models import common as cm
    from repro_torch.models import lm

    cfg = configs.get_reduced(arch, attn_impl="pallas")
    spec = {k: 6 for k in ("patches", "frames")
            if k in LM_FAMILIES.get(arch, {})}
    host = lm.init_params(cfg, 0, device="cpu")
    card_params = cm.tree_map(lambda _, t: t.to(dev), host)
    hb = _family_inputs(cfg, dict(spec, T=40), "cpu", 3, B=2)
    lc, _, launches = _forward_record(
        cfg, card_params, {k: v.to(dev) for k, v in hb.items()})
    lh, _ = lm.forward(cfg, host, hb)
    err = max_abs_err(lc.cpu(), lh)
    np.testing.assert_allclose(lc.cpu().numpy(), lh.numpy(),
                               rtol=LM_CROSS_TOL, atol=LM_CROSS_TOL,
                               err_msg=f"{arch}: card vs cpu logits")
    rng = np.random.RandomState(4)
    prompts = [[int(t) for t in rng.randint(2, cfg.vocab, n)]
               for n in (3, 9, 5, 12)]
    if spec:
        hb = _family_inputs(cfg, dict(spec, T=1), "cpu", 5, B=4)
        hb["tokens"] = _pad_left(prompts, "cpu")
        tok_c = _greedy(cfg, card_params,
                        {k: v.to(dev) for k, v in hb.items()}, 6, 32)[0]
        tok_h = _greedy(cfg, host, hb, 6, 32)[0]
        tok_c, tok_h = tok_c.tolist(), tok_h.tolist()
    else:
        tok_c, _ = _serve(cfg, card_params, prompts, 6, 32, dev)
        tok_h, _ = _serve(cfg, host, prompts, 6, 32, "cpu")
    assert tok_c == tok_h, f"{arch}: card and CPU tokens differ"
    want = _flash_per_forward(cfg)
    assert launches["flash_attention"] == want, (arch, launches, want)
    assert launches["flash_attention_mma"] == 0, (arch, launches)  # f32
    return dict(max_abs_err=err, launches=launches, serve_tokens_equal=True)


def lm_families_phase(dev) -> tuple[dict, dict]:
    """The nine architectures besides Jamba at their published widths
    (bf16, attn_impl "pallas", seed-0 weights; LM_FAMILIES gives the depth
    and inputs of each): a forward with exact launch counts, each flash
    launch's visited tiles and the first launch at each shape against the
    plain version, a short serve, 2 layers of the kernel path against the
    plain path, the reduced config card vs CPU, and the weights freed
    before the next; then the flash kernel's rows at the new shapes
    (:func:`family_flash_rows`)."""
    from repro_torch import configs
    from repro_torch.models import common as cm
    from repro_torch.models import lm

    out = {}
    rng = np.random.RandomState(20)
    for arch, spec in LM_FAMILIES.items():
        t_arch = time.perf_counter()
        cfg = configs.get(arch, n_layers=spec["layers"], attn_impl="pallas")
        params = lm.init_params(cfg, 0, device=dev)
        leaves = [t for _, t in cm.leaves(params)]
        rec = dict(layers=cfg.n_layers,
                   published_layers=configs.get(arch).n_layers,
                   params=sum(t.numel() for t in leaves),
                   param_bytes=sum(t.nbytes for t in leaves))
        del leaves
        batch = _family_inputs(cfg, spec, dev, 1)
        with FlashVisits() as seen:        # the first call: cuBLAS plans
            _forward_record(cfg, params, batch)
        logits, wall, launches = _forward_record(cfg, params, batch)
        P, S = spec.get("patches", 0), spec.get("frames", 0)
        rec["forward"] = dict(
            tokens=spec["T"], patches=P, frames=S, wall_s=wall,
            tokens_per_s=spec["T"] / wall,
            positions_per_s=(P + spec["T"] + S) / wall,
            peak_mem_bytes=torch.cuda.max_memory_allocated(),
            launches=launches,
            logits_finite=bool(torch.isfinite(logits).all()),
            logits_std=float(logits.std()), visited=seen)
        assert tuple(logits.shape) == (1, P + spec["T"], cfg.vocab), (
            arch, logits.shape)
        assert rec["forward"]["logits_finite"], (arch, "non-finite logits")
        assert launches["flash_attention"] == launches[
            "flash_attention_mma"] == spec["flash"] == len(seen) == (
            _flash_per_forward(cfg)), (arch, launches, len(seen))
        del logits
        if cfg.local_global_period:
            # local layers visit the windowed count, fewer than global ones
            local = {v["visited"] for v in seen if v["window"]}
            glob = {v["visited"] for v in seen if not v["window"]}
            assert len(local) == len(glob) == 1 and min(glob) > max(local), (
                arch, local, glob)
            rec["visited_local_global"] = [max(local), max(glob)]
        rec["serve"] = _family_serve(arch, cfg, params, spec, rng)
        if spec["flash"]:
            rec["kernel_vs_plain"] = _family_vs_plain(arch, cfg, params,
                                                      batch)
        del params, batch
        torch.cuda.empty_cache()
        rec["cross_check"] = _family_cross_check(arch, dev)
        rec["wall_s"] = time.perf_counter() - t_arch
        print(json.dumps({"lm_family": {arch: rec}}))
        out[arch] = rec
    return out, family_flash_rows(dev)


# the flash kernel at the new families' shapes (rows 4b-4f of PERF.md's
# table): name -> (B, Tq, Tk, Hq, Hkv, D, options, the family's cell)
FAMILY_FLASH = {
    "flash_attention_gemma2_global": (
        1, 8192, 8192, 32, 16, 128,
        dict(causal=True, softcap=50.0, scale=144.0 ** -0.5), "gemma2-27b"),
    "flash_attention_gemma2_local": (
        1, 8192, 8192, 32, 16, 128,
        dict(causal=True, window=4096, softcap=50.0, scale=144.0 ** -0.5),
        "gemma2-27b"),
    "flash_attention_paligemma_prefix": (
        1, 1024, 1024, 8, 1, 256, dict(causal=True, prefix_len=256),
        "paligemma-3b"),
    "flash_attention_seamless_encoder": (
        1, 1024, 1024, 16, 16, 64, dict(causal=False),
        "seamless-m4t-large-v2"),
    "flash_attention_seamless_cross": (
        1, 512, 1024, 16, 16, 64, dict(causal=False),
        "seamless-m4t-large-v2"),
}


def _library_call(q, k, v, kw, dev):
    """One PyTorch call that computes the same attention as the kernel on
    [B, H, T, D] copies of the inputs, used only as a yardstick: SDPA
    (the prefix as a boolean mask), or, with a softcap, which SDPA lacks,
    compiled flex_attention with the softcap as its score_mod and the
    causal window as its block mask.  Returns (name, a zero-argument
    call)."""
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    if kw.get("softcap"):
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)

        cap, window = kw["softcap"], kw.get("window") or Tk
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))

        def score_mod(s, b, h, qi, ki):
            return cap * torch.tanh(s / cap)

        def mask_mod(b, h, qi, ki):
            return (ki <= qi) & (ki > qi - window)

        mask = create_block_mask(mask_mod, None, None, Tq, Tk, device=dev)
        flex = torch.compile(flex_attention, dynamic=False)
        return "flex_attention (torch.compile)", lambda: flex(
            qt, kt, vt, score_mod=score_mod, block_mask=mask,
            scale=kw["scale"], enable_gqa=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kt, vt = (t.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2)
              .contiguous() for t in (k, v))
    extra = dict(is_causal=kw["causal"])
    if kw.get("prefix_len"):
        qp = torch.arange(Tq, device=dev)[:, None]
        kp = torch.arange(Tk, device=dev)[None, :]
        extra = dict(attn_mask=(kp <= qp) | (kp < kw["prefix_len"]))
    return "scaled_dot_product_attention", lambda: sdpa(qt, kt, vt, **extra)


def family_flash_rows(dev) -> dict:
    """flash_attention at each FAMILY_FLASH shape, bf16: against its plain
    version (FLASH_TOL), the visited tiles against the host's count, then
    timed as lm_kernel_phase times it, beside one PyTorch call that
    computes the same function (:func:`_library_call`)."""
    from repro_torch.kernels import attention as kattn

    rows = {}
    for name, (B, Tq, Tk, Hq, Hkv, D, kw, cell) in FAMILY_FLASH.items():
        var = kattn.variant(torch.bfloat16, D)
        q, k, v = _randn(((B, Tq, Hq, D), (B, Tk, Hkv, D), (B, Tk, Hkv, D)),
                         torch.bfloat16, Tq + D, dev)
        mma0 = kattn.flash_attention.mma_launches
        vis = torch.zeros(B * Hq * -(-Tq // var.bq), dtype=torch.int32,
                          device=dev)
        got = kattn.flash_attention(q, k, v, visited=vis, **kw)
        assert kattn.flash_attention.mma_launches - mma0 == 1, name
        mask = {o: kw[o] for o in ("causal", "window", "prefix_len")
                if o in kw}
        assert int(vis.sum()) == B * Hq * kattn.visited_tiles(
            Tq, Tk, bq=var.bq, bk=var.bk, **mask), (name, "visited tiles")
        want = kattn.flash_attention_plain(q, k, v, **kw)
        rtol, atol = FLASH_TOL[torch.bfloat16]
        err = max_abs_err(got.float().cpu(), want.float().cpu())
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)
        del want
        library, lib = _library_call(q, k, v, kw, dev)
        lib_err = max_abs_err(got.float().cpu(),
                              lib().transpose(1, 2).float().cpu())
        library_ms = time_ms(lib, n=30, warmup=3)
        del lib
        pairs = visible_pairs(Tq, Tk, **mask)
        flops = 4 * D * B * Hq * pairs
        n_bytes = q.nbytes + k.nbytes + v.nbytes + got.nbytes
        b_ms, b_by = bound_ms(n_bytes, flops, H100_BF16_OPS_PER_S)
        rows[name] = dict(
            shape=f"B={B} Tq={Tq} Tk={Tk} Hq={Hq} Hkv={Hkv} D={D} bf16 "
                  + " ".join(f"{o}={kw[o]}" for o in kw),
            cell=cell, variant=f"{var.name} (BQ={var.bq}, BK={var.bk})",
            max_abs_err=err, library=library,
            max_abs_err_vs_library=lib_err,
            visible_pairs=pairs, tiles_visited=int(vis.sum()),
            ms=time_ms(lambda: kattn.flash_attention(q, k, v, **kw), n=30,
                       warmup=3),
            device_ms=graph_ms(lambda: kattn.flash_attention(q, k, v, **kw),
                               n=10),
            host_us=host_us(lambda: kattn.flash_attention(q, k, v, **kw),
                            n=100, reps=3),
            plain_ms=time_ms(lambda: kattn.flash_attention_plain(q, k, v,
                                                                 **kw),
                             n=5, warmup=1),
            library_ms=library_ms, bytes=n_bytes, ops=flops,
            ops_per_s=H100_BF16_OPS_PER_S, bound_ms=b_ms, bound_by=b_by)
        print(json.dumps({name: rows[name]}))
        del q, k, v, got, vis
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# The train phase (slice 10): LM training on the card
# ---------------------------------------------------------------------------

# the reduced configs' steps, as tests/test_torch_train_step*.py run them
TRAIN_STEP_KW = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10,
                     xent_chunk=16)
TRAIN_CROSS_STEPS = 2
TRAIN_TOL = 1e-4           # reduced config in f32, card vs CPU, every leaf
# granite-3-2b whole at its published widths, bf16 compute, f32 state,
# remat "nothing": 2.53 B parameters, 40.5 GB of parameters, gradients and
# moments.  B x T: the largest batch of 2048-token sequences that fits
# (PERF.md section 4); one more step after the timed ones runs under
# torch.profiler
TRAIN_FULL = dict(arch="granite-3-2b", B=16, T=2048, steps=4,
                  xent_chunk=512)
TRAIN_LAUNCH = dict(arch="granite-3-2b", steps=8, fail_at=5)
TRAIN_RESUME_RTOL = 1e-5   # resume on the card, where bit equality fails


def _state_leaves(state) -> list:
    from repro_torch.models import common as cm
    return cm.leaves(state)


def _states_close(name, got, want, tol) -> float:
    """Every leaf of two train states (any devices) within rtol = atol =
    ``tol``; returns the largest absolute difference."""
    err = 0.0
    pairs_w = dict(_state_leaves(want))
    pairs_g = _state_leaves(got)
    assert [p for p, _ in pairs_g] == list(pairs_w), name
    for path, g in pairs_g:
        g = g.detach().cpu()
        w = pairs_w[path].detach().cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, (name, path)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=tol, atol=tol,
                                   err_msg=f"{name} {'/'.join(path)}")
        err = max(err, max_abs_err(g.numpy(), w.numpy()))
    return err


def _states_equal(got, want) -> bool:
    return all(torch.equal(g.cpu(), w.cpu()) for (_, g), (_, w) in zip(
        _state_leaves(got), _state_leaves(want)))


def train_cross_check(arch: str, dev) -> dict:
    """TRAIN_CROSS_STEPS train steps of the reduced config in f32 on the
    card and on the CPU, from one seed-0 state and the same batches (B = 2,
    T = 24): loss, grad_norm and lr each step, and every parameter and
    moment leaf after each step, within TRAIN_TOL; no kernel launched."""
    from repro_torch import configs, kernels
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import common as cm
    from repro_torch.train import step as step_mod

    cfg = configs.get_reduced(arch)
    assert cfg.attn_impl == "chunked" and cfg.compute_dtype == "float32"
    host = step_mod.init_state(cfg, 0, device="cpu")
    card = cm.tree_map(lambda _, t: t.to(dev, copy=True), host)
    step = step_mod.make_train_step(cfg, **TRAIN_STEP_KW)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=24, global_batch=2, seed=3)
    rec = dict(metrics=[], max_abs_err=[])
    kernels.reset_launch_counts()
    for i in range(TRAIN_CROSS_STEPS):
        batch = make_batch(dcfg, i, model_cfg=cfg)
        card, mc = step(card, batch)
        host, mh = step(host, batch)
        for k in ("loss", "grad_norm", "lr", "tokens", "moe_lb", "moe_z",
                  "moe_dropped"):
            np.testing.assert_allclose(float(mc[k]), float(mh[k]),
                                       rtol=TRAIN_TOL, atol=TRAIN_TOL,
                                       err_msg=f"{arch} step {i} {k}")
        assert int(card["opt"].step) == int(host["opt"].step) == i + 1
        rec["metrics"].append({k: [float(mc[k]), float(mh[k])]
                               for k in ("loss", "grad_norm", "lr")})
        rec["max_abs_err"].append(_states_close(f"{arch} step {i}", card,
                                                host, TRAIN_TOL))
    rec["launches"] = kernels.launch_counts()
    assert not any(rec["launches"].values()), (arch, rec["launches"])
    return rec


def train_full_width(dev) -> dict:
    """One architecture whole at its published widths (TRAIN_FULL): the
    seed-0 f32 train state on the card, bf16 compute, remat "nothing", one
    warm-up step and ``steps - 1`` timed steps of B x T tokens, with the
    launch counters set to 0 just before and read just after (training
    launches neither flash_attention nor linear_scan).  The loss finite,
    the step counter at ``steps``, the parameters moved."""
    from repro_torch import configs, kernels
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import common as cm
    from repro_torch.train import step as step_mod

    spec = TRAIN_FULL
    cfg = configs.get(spec["arch"], remat=True, remat_policy="nothing")
    assert cfg.attn_impl == "chunked" and cfg.compute_dtype == "bfloat16"
    B, T = spec["B"], spec["T"]
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = step_mod.init_state(cfg, 0, device=dev)
    torch.cuda.synchronize()
    rec = dict(arch=cfg.name, B=B, T=T, layers=cfg.n_layers,
               compute_dtype=cfg.compute_dtype, remat=cfg.remat_policy,
               init_s=time.perf_counter() - t0)
    leaves = [t for _, t in cm.leaves(state["params"])]
    rec["params"] = sum(t.numel() for t in leaves)
    rec["state_bytes"] = sum(t.nbytes for _, t in cm.leaves(state))
    probe = {path: t.reshape(-1)[:4096].to("cpu", copy=True)
             for path, t in cm.leaves(state["params"])}
    del leaves
    step = step_mod.make_train_step(cfg, peak_lr=3e-4, warmup_steps=2,
                                    total_steps=100,
                                    xent_chunk=spec["xent_chunk"])
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=T, global_batch=B, seed=0)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    walls, losses, gnorms = [], [], []
    for i in range(spec["steps"]):
        batch = make_batch(dcfg, i, model_cfg=cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    rec["launches"] = kernels.launch_counts()
    rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    rec["step_walls_s"] = walls
    rec["step_s"] = statistics.median(walls[1:])
    rec["tokens_per_s"] = B * T / rec["step_s"]
    # 6 N a token for the forward and backward, 2 N for the remat forward
    rec["model_tflop_per_s"] = 8 * rec["params"] * B * T / rec[
        "step_s"] / 1e12
    rec["losses"], rec["grad_norms"] = losses, gnorms
    rec["step_counter"] = int(state["opt"].step)
    rec["params_moved"] = sum(
        not torch.equal(t.reshape(-1)[:4096].cpu(), probe[path])
        for path, t in cm.leaves(state["params"]))
    assert all(np.isfinite(losses)) and all(np.isfinite(gnorms)), rec
    assert rec["step_counter"] == spec["steps"], rec
    assert rec["params_moved"] == len(probe), rec
    assert rec["launches"]["flash_attention"] == 0, rec["launches"]
    assert rec["launches"]["linear_scan"] == 0, rec["launches"]
    batch = make_batch(dcfg, spec["steps"], model_cfg=cfg)
    _, prof = profiled(lambda: step(state, batch))
    rec["profile"] = _train_profile(prof)
    assert not rec["profile"]["our_kernels_count_ms"], rec["profile"]
    del state, probe
    torch.cuda.empty_cache()
    return rec


def _train_profile(prof: dict) -> dict:
    """A profiled train step's device time split into the f32 products
    (the chunked attention's, on the CUDA cores), the bf16 products (the
    weights', on the tensor cores) and the rest (elementwise, reductions,
    copies)."""
    split = {"f32_products": 0.0, "bf16_products": 0.0, "other": 0.0}
    for name, ms in prof["device_kernel_ms"].items():
        low = name.lower()
        if "gemm" in low and "f32f32" in low:
            split["f32_products"] += ms
        elif "nvjet" in low or ("gemm" in low and "bf16" in low):
            split["bf16_products"] += ms
        else:
            split["other"] += ms
    keep = ("wall_s", "device_busy_s", "device_idle_share",
            "kernel_launches", "host_reads", "top_device_ms",
            "our_kernels_count_ms")
    return dict({k: prof[k] for k in keep}, device_ms_by_class=split)


def train_launcher(dev, out: pathlib.Path, spec: dict = TRAIN_LAUNCH) -> dict:
    """``launch.train.main`` on the card, reduced config, with checkpoints:
    an uninterrupted run; a run that stops at ``--fail-at`` (exit 42) and
    its ``--resume``, whose final state equals the uninterrupted one (bit
    for bit, else within TRAIN_RESUME_RTOL: recorded); the card's final
    checkpoint restored on the CPU and on the card, equal."""
    import shutil

    from repro_torch import configs, kernels
    from repro_torch.launch import train as train_mod
    from repro_torch.train import step as step_mod
    from repro_torch.train.ckpt import Checkpointer

    base = out / "train_ckpt"
    shutil.rmtree(base, ignore_errors=True)

    def args(d, *more):
        return ["--arch", spec["arch"], "--reduced", "--steps",
                str(spec["steps"]), "--batch", "4", "--seq", "32",
                "--ckpt-every", "2", "--log-every", "4", "--xent-chunk",
                "16", "--ckpt-dir", str(base / d), "--device", str(dev),
                *more]

    kernels.reset_launch_counts()
    rc = [train_mod.main(args("straight")),
          train_mod.main(args("broken", "--fail-at", str(spec["fail_at"]))),
          train_mod.main(args("broken", "--resume"))]
    launches = kernels.launch_counts()
    assert rc == [0, 42, 0], rc
    assert not any(launches.values()), launches
    cfg = configs.get_reduced(spec["arch"])
    target = step_mod.init_state(cfg, 0, device="meta")
    a, sa = Checkpointer(base / "straight").restore(target, device=dev)
    b, sb = Checkpointer(base / "broken").restore(target, device=dev)
    b_cpu, _ = Checkpointer(base / "broken").restore(target, device="cpu")
    assert sa == sb == spec["steps"], (sa, sb)
    assert _states_equal(b, b_cpu), "card and CPU restores differ"
    bit_equal = _states_equal(a, b)
    err = (0.0 if bit_equal else
           _states_close("resume vs uninterrupted", b, a, TRAIN_RESUME_RTOL))
    return dict(return_codes=rc, launches=launches, resume_bit_equal=bit_equal,
                resume_max_abs_err=err, steps=spec["steps"],
                fail_at=spec["fail_at"], cpu_restore_equal=True)


def train_grad_guard(dev) -> dict:
    """flash_attention and linear_scan refuse card tensors that require
    grad (no backward), and launch under torch.no_grad()."""
    from repro_torch.kernels import attention as kattn
    from repro_torch.kernels import ssm as kssm

    gen = torch.Generator(device=dev).manual_seed(21)
    q, k, v = (torch.randn((1, 128, h, 64), generator=gen, device=dev,
                           dtype=torch.bfloat16) for h in (4, 2, 2))
    a = torch.rand((2, 64, 256), generator=gen, device=dev)
    x = torch.randn((2, 64, 256), generator=gen, device=dev)
    out = {}
    for name, fn, ins, i in (
            ("flash_attention", kattn.flash_attention, [q, k, v], 0),
            ("linear_scan", kssm.linear_scan, [a, x], 1)):
        before = fn.launches
        ins[i].requires_grad_(True)
        try:
            fn(*ins)
        except RuntimeError as e:
            assert "no backward" in str(e), e
            raised = True
        else:
            raised = False
        assert raised and fn.launches == before, name
        with torch.no_grad():
            fn(*ins)
        assert fn.launches == before + 1, name
        ins[i].requires_grad_(False)
        out[name] = dict(raised=raised, launched_under_no_grad=True)
    return out


def train_phase(dev, out: pathlib.Path) -> dict:
    """The train phase: (a) each reduced config's steps card vs CPU, (b) the
    full-width cell, (c) the launcher's fail/resume on the card, (d) the
    kernel wrappers' grad guard on card tensors."""
    from repro_torch import configs

    rec = {"cross_check": {}}
    t0 = time.perf_counter()
    for arch in configs.ARCHS:
        rec["cross_check"][arch] = train_cross_check(arch, dev)
    rec["cross_check_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["train_full_width"] = train_full_width(dev)
    rec["train_full_width"]["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"train_full_width": rec["train_full_width"]}))
    t0 = time.perf_counter()
    rec["launcher"] = train_launcher(dev, out)
    rec["launcher"]["wall_s"] = time.perf_counter() - t0
    rec["grad_guard"] = train_grad_guard(dev)
    print(json.dumps({"train": {k: rec[k] for k in (
        "cross_check_s", "launcher", "grad_guard")}}))
    return rec


# ---------------------------------------------------------------------------
# The fleet phase (slice 11): the dry run on meta tensors, the energy-aware
# fleet's scheduler matrix on the card
# ---------------------------------------------------------------------------

# The dry run's cells here: every arch at decode_32k and long_500k (the
# full-attention archs skip it).  prefill_32k and train_4k take minutes a
# cell on meta tensors (a chunked-attention step of 32,768 positions runs
# ~5 M aten ops), so they are cut (PERF.md section 4).
FLEET_SHAPES = ("decode_32k", "long_500k")
FLEET_WORKERS = 8
FLEET_JOBS = dict(n_jobs=24, seed=2, arrival_spread_s=3600.0, n_pods=8)
# the cell counted on real card tensors and on meta tensors
FLEET_COUNT = dict(arch="granite-3-2b", batch=1, seq=4096)


def _fleet_cell_worker(job) -> dict:
    """One published cell through ``launch.dryrun.run_cell`` (meta
    tensors, no device), its record written under ``out``."""
    arch, shape_name, out = job
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell(arch, shape_name)
    pathlib.Path(out, f"{arch}_{shape_name}_1x1.json").write_text(
        json.dumps(rec, indent=1))
    return {k: rec.get(k) for k in ("arch", "shape", "ok", "skipped",
                                    "run_s", "error")}


def _fleet_jobs(out: pathlib.Path, shapes=FLEET_SHAPES) -> list:
    """The dry run's cells (every arch at ``shapes``), their records to go
    under ``out`` (emptied first)."""
    from repro_torch import configs

    out.mkdir(parents=True, exist_ok=True)
    for old in out.glob("*.json"):
        old.unlink()
    return [(a, s, str(out)) for s in shapes for a in configs.ARCHS]


def _rows_close(name: str, got: list, want: list):
    """Scheduler rows: labels and integers exact, floats within RTOL /
    ATOL."""
    assert len(got) == len(want), (name, len(got), len(want))
    for g, w in zip(got, want):
        assert set(g) == set(w), (name, set(g) ^ set(w))
        for k, v in w.items():
            if isinstance(v, float):
                np.testing.assert_allclose(
                    g[k], v, rtol=RTOL, atol=ATOL,
                    err_msg=f"{name} {w['vm_sched']}/{w['pm_sched']} {k}")
            else:
                assert g[k] == v, (name, k, g[k], v)


def fleet_count_both_ways(dev, spec: dict = FLEET_COUNT) -> dict:
    """One published cell (granite-3-2b prefill, B x T) counted by
    launch.op_cost on real card tensors (random, of the meta arguments'
    shapes and dtypes) and on meta tensors: product and pointwise FLOPs
    must be equal; the meta peak beside the card's
    max_memory_allocated above the arguments (recorded, not asserted)."""
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun, op_cost
    from repro_torch.launch.mesh import host_mesh

    cfg = configs.get(spec["arch"])
    shape = ShapeCell("fleet_count", "prefill", spec["seq"], spec["batch"])
    fn, args, _ = dryrun.build_cell(cfg, shape, host_mesh())
    t0 = time.perf_counter()
    _, meta = op_cost.count(fn, *args)
    meta_s = time.perf_counter() - t0
    real = dryrun.materialize(args, dev, vocab=cfg.vocab, seed=0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, card_count = op_cost.count(fn, *real)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    logits = out[0]
    assert logits.shape == (spec["batch"], cfg.vocab), logits.shape
    a, b = meta.summary(), card_count.summary()
    rec = dict(spec, meta=a, card={k: b[k] for k in (
        "dot_flops", "elem_flops", "bytes_accessed", "n_ops", "peak_bytes")},
        meta_s=meta_s, card_s=card_s, card_max_memory_allocated=peak,
        meta_peak_bytes=a["peak_bytes"])
    del out, real, card_count
    torch.cuda.empty_cache()
    for k in ("dot_flops", "elem_flops"):
        assert a[k] == b[k], ("fleet: card and meta counts differ", k,
                              a[k], b[k])
    return rec


def idle_draw_w(samples: int = 5) -> dict:
    """The card's power draw with no work queued: nvidia-smi's power.draw
    after the queue drained and a second's rest, ``samples`` readings
    0.2 s apart, and their median."""
    torch.cuda.synchronize()
    time.sleep(1.0)
    draws = []
    for _ in range(samples):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.draw",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout.strip().splitlines()[0]
        draws.append(float(smi))
        time.sleep(0.2)
    return dict(samples_w=draws, median_w=statistics.median(draws))


def fleet_phase(dev, out: pathlib.Path) -> dict:
    """The fleet phase: (a) the dry run of FLEET_SHAPES on meta tensors in
    a pool of FLEET_WORKERS spawned processes (closed before it returns),
    every record ok; meanwhile on the card (b) one published cell counted
    on card and meta tensors and (c) the card's idle draw beside the H100
    record's; then (d) load_cells with the H100 record, default_job_mix and
    job_trace, and (e) evaluate_schedulers over the 15 policy pairs on the
    card (launch counters set to 0 just before and read just after; the
    solve and the masked min must launch) and on the CPU, rows equal
    within tolerance."""
    import multiprocessing

    from repro_torch.sched import energy_aware as ea

    dry_dir = out / "fleet_dryrun"
    jobs = _fleet_jobs(dry_dir)
    rec = {}
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(
            min(FLEET_WORKERS, len(jobs))) as pool:
        pending = pool.map_async(_fleet_cell_worker, jobs)
        # the card's part runs while the pool counts (the workers use no
        # device)
        rec["count_both_ways"] = fleet_count_both_ways(dev)
        rec["idle_draw"] = dict(idle_draw_w(),
                                h100_record_idle_w=ea.H100.idle_w)
        dry = pending.get()
    rec["dry_run"] = dict(wall_s=time.perf_counter() - t0, cells=dry,
                          counted=sum(not c["skipped"] for c in dry))
    failed = [c for c in dry if not c["ok"]]
    assert not failed, ("fleet: dry-run cells failed", failed)

    cells = ea.load_cells(dry_dir, chip=ea.H100)
    assert len(cells) == rec["dry_run"]["counted"], sorted(cells)
    rec["cells"] = {f"{a}/{s}": dict(dataclasses.asdict(c), step_s=c.step_s,
                                     bottleneck=c.bottleneck,
                                     utilisation=c.utilisation)
                    for (a, s), c in sorted(cells.items())}
    mix = ea.default_job_mix(cells, n_jobs=FLEET_JOBS["n_jobs"],
                             seed=FLEET_JOBS["seed"])
    trace = ea.job_trace(mix, cells,
                         arrival_spread_s=FLEET_JOBS["arrival_spread_s"],
                         seed=FLEET_JOBS["seed"])
    n_pods = FLEET_JOBS["n_pods"]
    rows, wall, launches = _counted(
        lambda: ea.evaluate_schedulers(trace, n_pods=n_pods), "cuda")
    cpu_rows, cpu_wall = timed_call(
        lambda: ea.evaluate_schedulers(trace, n_pods=n_pods,
                                       devices=["cpu"]), "cpu")
    _rows_close("fleet card vs cpu", rows, cpu_rows)
    assert launches["maxmin_solve"] > 0 and launches["masked_min"] > 0, (
        "fleet: the matrix launched no solve or masked min", launches)
    events = sum(r["events"] for r in rows)
    rec["matrix"] = dict(
        jobs=[dataclasses.astuple(j) for j in mix], tasks=int(trace.n),
        n_pods=n_pods, rows=rows, wall_s=wall, cpu_wall_s=cpu_wall,
        events=events, aggregate_events_per_s=events / wall,
        launches=launches)
    print(json.dumps({"fleet": {
        "dry_run_wall_s": rec["dry_run"]["wall_s"],
        "matrix": {k: rec["matrix"][k] for k in (
            "tasks", "wall_s", "cpu_wall_s", "events",
            "aggregate_events_per_s", "launches")},
        "count_both_ways": {k: rec["count_both_ways"][k] for k in (
            "meta_s", "card_s", "meta_peak_bytes",
            "card_max_memory_allocated")},
        "idle_draw": rec["idle_draw"]}}))
    return rec


def dense_cell_worker(root: str, n_tasks: int, n_profile: int) -> dict:
    """full_width_dense as the checkout at ``root`` runs it (its own
    ``repro_torch``, built into its own ``build/``): ``n_tasks`` tasks
    timed, their events and readings (hex of the bits), then
    ``n_profile`` tasks under torch.profiler (launches and host reads a
    pass, device idle share)."""
    sys.path.insert(0, str(pathlib.Path(root).resolve() / "src"))
    from repro_torch.core import engine
    from repro_torch.core.trace import filter_fitting, gwa_like_trace

    assert pathlib.Path(engine.__file__).is_relative_to(
        pathlib.Path(root).resolve()), engine.__file__
    rec = {"root": str(root)}
    for tasks in (n_tasks, n_profile):
        trace = filter_fitting(gwa_like_trace("das2", tasks, seed=7), 64.0)
        spec, params = engine.make_cloud(n_pm=500, n_vm=4096, pm_cores=64.0,
                                         pm_sched="ondemand",
                                         max_events=4_000_000)
        if tasks == n_tasks:
            res, wall = run(spec, trace, params, "cuda")
            rec.update(tasks=int(trace.n), events=int(res.n_events),
                       wall_s=wall, events_per_s=int(res.n_events) / wall,
                       readings={k: v.cpu().numpy().tobytes().hex()
                                 for k, v in res.readings(spec).items()})
        else:
            (res, _), prof = profiled(lambda: run(spec, trace, params,
                                                  "cuda"))
            events = int(res.n_events)
            rec["profile"] = dict(
                tasks=int(trace.n), events=events,
                kernel_launches_per_pass=prof["kernel_launches"] / events,
                host_reads_per_pass=prof["host_reads"] / events,
                device_idle_share=prof["device_idle_share"],
                wall_s=prof["wall_s"])
    return rec


def compare_parent(parent: str, n_tasks: int) -> dict:
    """full_width_dense of the parent checkout at ``parent`` against this
    checkout's, in turns parent, change, change, parent, each in a process
    of its own: events and every reading bit for bit, host reads a pass no
    more than the parent's, kernel launches a pass within 5%."""
    runs = []
    for root in (parent, ROOT, ROOT, parent):
        done = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dense-worker",
             str(root), "--tasks", str(n_tasks)], capture_output=True,
            text=True, timeout=900)
        assert done.returncode == 0, done.stderr[-4000:]
        runs.append(json.loads(done.stdout.strip().splitlines()[-1]))
    p, c = runs[0], runs[1]
    lp = p["profile"]["kernel_launches_per_pass"]
    lc = c["profile"]["kernel_launches_per_pass"]
    out = dict(
        turns=[dict(root=r["root"], events=r["events"], wall_s=r["wall_s"],
                    events_per_s=r["events_per_s"], profile=r["profile"])
               for r in runs],
        events_equal=all(r["events"] == p["events"] for r in runs),
        readings_bit_equal=all(r["readings"] == p["readings"] for r in runs),
        host_reads_per_pass=[p["profile"]["host_reads_per_pass"],
                             c["profile"]["host_reads_per_pass"]],
        launches_per_pass=[lp, lc], launches_ratio=lc / lp)
    print(json.dumps({"compare_parent": out}))
    assert out["events_equal"] and out["readings_bit_equal"], out
    assert (out["host_reads_per_pass"][1] <= out["host_reads_per_pass"][0]
            ), out["host_reads_per_pass"]
    assert abs(out["launches_ratio"] - 1.0) <= 0.05, out["launches_per_pass"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tasks", type=int, default=1000,
                    help="DAS-2-like tasks of the full-width run")
    ap.add_argument("--out", default=str(ROOT / "build" / "chip_smoke"))
    ap.add_argument("--compare-parent", metavar="DIR",
                    help="only compare full_width_dense with the checkout "
                         "at DIR (the parent commit, unpacked)")
    ap.add_argument("--dense-worker", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if args.dense_worker:
        print(json.dumps(dense_cell_worker(args.dense_worker, args.tasks,
                                           CAPTURE_TASKS)))
        return 0
    if args.compare_parent:
        record = {"card": card(),
                  "compare_parent": compare_parent(
                      args.compare_parent, args.tasks)}
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "compare_parent.json").write_text(json.dumps(record, indent=1))
        return 0
    from repro_torch.kernels import _build

    # torch.compile (the flex_attention yardstick of family_flash_rows)
    # keeps its caches beside the build
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(pathlib.Path(args.out).parent / sub))
    record = {"card": card()}
    dev = torch.device("cuda")
    from repro_torch.device import match_xla_matmul
    match_xla_matmul()

    t0 = time.perf_counter()
    build_s = _build.build_all()
    ptxas = {n: ptxas_report(_build.build_log(n)) for n in _build.SOURCES}
    record["build"] = dict(wall_s=time.perf_counter() - t0, per_source=build_s,
                           ptxas=ptxas)
    print(json.dumps({"build": record["build"]}))
    # the bf16 flash kernel at the head dims of the LMs: 128 (Jamba and the
    # dense families), 64 (granite, seamless) and 256 (paligemma)
    spills = {d: spill_stores(ptxas["attention"],
                              f"_Z16flash_mma_kernelILi{d}E")
              for d in (64, 128, 256)}
    record["build"]["flash_mma_spill_stores"] = spills
    print(json.dumps({"flash_mma_spill_stores": spills}))
    assert not any(spills.values()), ("the bf16 flash kernel spills",
                                      spills)
    solve = [v for k, v in ptxas["maxmin"].items()
             if k.startswith("_Z19maxmin_solve_kernel")]
    assert solve and " 0 bytes spill stores" in solve[0], (
        "the solve kernel spills", solve)

    phase_s = {"build": record["build"]["wall_s"]}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t
        return out

    kern, checks = timed("kernels", kernel_phase, dev, CAPTURE_TASKS)
    lane_kern, lane_checks = timed("lane_kernels", lane_kernel_phase, dev,
                                   CAPTURE_TASKS)
    lm_kern, lm_checks = timed("lm_kernels", lm_kernel_phase, dev)
    kern.update(lane_kern)
    kern.update(lm_kern)
    checks.update(lane_checks)
    checks.update(lm_checks)
    record["kernel_checks"] = checks
    print(json.dumps({"kernel_checks": checks}))
    main, main_bits, main_outputs = timed("main_path", main_path,
                                          args.tasks)
    record["main_path"] = main
    main.update(timed("batched_path", batched_path, args.tasks, main,
                      main_bits))
    main.update(timed("streaming_path", streaming_path, args.tasks, main,
                      main_bits, main_outputs))
    record["batched_matrix"] = timed("batched_matrix", batched_matrix)
    record["cross_check"], cross_mono = timed("cross_check", cross_check)
    record["cross_check_evacuate"], _ = timed("cross_check_evacuate",
                                              cross_check, "evacuate")
    record["streaming_cross_check"] = timed(
        "streaming_cross_check", streaming_cross_check, cross_mono)
    # above the gate the main path's 100 tasks
    record["profile"] = timed("profile", profile_phase, PROFILE_TASKS, 100,
                              PROFILE_TASKS)
    sharing = record["sharing"] = {}
    sharing["validation"] = timed("sharing_validation", sharing_validation)
    sharing["fig12"] = timed("sharing_fig12", sharing_fig12)
    sharing["network_full_width"] = timed("network_full_width",
                                          network_full_width)
    for cell in ("network_cross_check", "network_above_gate"):
        sharing[cell] = timed(cell, network_cross_check, cell)
    sharing["cloud_facade"] = timed("cloud_facade", cloud_facade, cross_mono)
    record["main_path"].update(timed("lm", lm_phase, dev))
    families, family_rows = timed("lm_families", lm_families_phase, dev)
    record["main_path"]["lm_families"] = families
    record["main_path"]["train"] = timed("train", train_phase, dev,
                                         pathlib.Path(args.out))
    record["main_path"]["fleet"] = timed("fleet", fleet_phase, dev,
                                         pathlib.Path(args.out))
    record["phase_s"] = phase_s
    print(json.dumps({"phase_s": phase_s}))

    sources = {"maxmin_solve": ("src/repro_torch/csrc/maxmin.cu",
                                "src/repro/kernels/maxmin.py:201",
                                "full_width"),
               "fill_stats": ("src/repro_torch/csrc/maxmin.cu",
                              "src/repro/kernels/maxmin.py:84",
                              "above_gate"),
               "masked_min": ("src/repro_torch/csrc/horizon.cu",
                              "src/repro/kernels/horizon.py:55",
                              "full_width"),
               "flash_attention": ("src/repro_torch/csrc/attention.cu",
                                   "src/repro/kernels/attention.py:103",
                                   "lm_forward_full_width"),
               "linear_scan": ("src/repro_torch/csrc/scan.cu",
                               "src/repro/kernels/ssm.py:57",
                               "lm_serve_full_width")}
    # the lane-axis rows: the same kernels, one launch for every lane of a
    # batched cell
    sources.update({
        "maxmin_solve_lanes": ("src/repro_torch/csrc/maxmin.cu",
                               "src/repro/kernels/maxmin.py:201",
                               "batched_full_width"),
        "fill_stats_lanes": ("src/repro_torch/csrc/maxmin.cu",
                             "src/repro/kernels/maxmin.py:84",
                             "batched_above_gate"),
        "masked_min_lanes": ("src/repro_torch/csrc/horizon.cu",
                             "src/repro/kernels/horizon.py:55",
                             "batched_full_width")})
    # the sharing cells' launches of the two solve routes
    val = sharing["validation"]
    sharing_cells = {
        "fig7": val["fig7_cpu_sharing"]["launches"],
        "fig8_uncorrected": val["fig8_memory_corrected"]["uncorrected"][
            "launches"],
        "fig8_corrected": val["fig8_memory_corrected"]["corrected"][
            "launches"],
        "fig9": val["fig9_network_bottleneck"]["launches"],
        "fig10": val["fig10_power_staircase"]["launches"],
        "sharing_fig12": sharing["fig12"]["launches"],
        **{cell: sharing[cell]["launches"] for cell in (
            "network_full_width", "network_cross_check",
            "network_above_gate")},
        "cloud_facade_to_half": sharing["cloud_facade"]["launches"][0],
        "cloud_facade_resumed": sharing["cloud_facade"]["launches"][1]}
    rows = []
    for name, (src, replaces, cell) in sources.items():
        k = kern[name]
        b_ms, b_by = bound_ms(k["bytes"], k["ops"],
                              k.get("ops_per_s", H100_F32_OPS_PER_S))
        counter = name.removesuffix("_lanes")
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=record["main_path"][cell]["launches"][counter],
            max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
            bound_ms=b_ms, bound_by=b_by, library_ms=k.get("library_ms"),
            shape=k["shape"], main_path_cell=cell,
            streamed_launches={
                c: record["main_path"][c]["launches"][counter]
                for c in ("streaming_full_width", "streaming_batched")
                if counter in ("maxmin_solve", "masked_min")},
            **({"fleet_launches": record["main_path"]["fleet"]["matrix"][
                "launches"][counter]} if name in (
                    "maxmin_solve_lanes", "masked_min_lanes") else {}),
            sharing_launches={
                c: {k: launches[k] for k in (
                    ("fill_stats", "fill_plan") if counter == "fill_stats"
                    else (counter,))}
                for c, launches in sharing_cells.items()
                if counter in ("maxmin_solve", "fill_stats")
                and not name.endswith("_lanes")},
            **{x: k[x] for x in ("variant", "plan_ms", "public_ms",
                                 "graph_ms", "plan_graph_ms",
                                 "longest_segment", "device_ms", "host_us",
                                 "general_cases", "dense",
                                 "launch_floor_ms", "launch_floor_device_ms",
                                 "launch_floor_host_us", "plan_device_ms",
                                 "b1") if x in k}))
    # the solve at the sharing core's busiest pass (10,000 flows on one
    # spreader, sharing_fig12)
    k = sharing["fig12"]["busiest_pass_solve"]
    rows.append(dict(
        name="maxmin_solve_sharing", route="cuda",
        source="src/repro_torch/csrc/maxmin.cu",
        replaces="src/repro/kernels/maxmin.py:201",
        launches=sharing["fig12"]["launches"]["maxmin_solve"],
        max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
        bound_ms=k["bound_ms"], bound_by=k["bound_by"], library_ms=None,
        shape=k["shape"], main_path_cell="sharing_fig12",
        device_ms=k["device_ms"], host_us=k["host_us"]))
    # the flash kernel at the other families' shapes; launches: every flash
    # launch of the family's forward, and those at this row's shape
    for name, k in family_rows.items():
        B, Tq, Tk, Hq, Hkv, D, kw, cell = FAMILY_FLASH[name]
        fwd = families[cell]["forward"]
        key = (Tq, Tk, kw["causal"], kw.get("window", 0),
               kw.get("prefix_len", 0))
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/attention.cu",
            replaces="src/repro/kernels/attention.py:103",
            launches=fwd["launches"]["flash_attention"],
            launches_at_this_shape=sum(
                (v["Tq"], v["Tk"], v["causal"], v["window"], v["prefix_len"])
                == key for v in fwd["visited"]),
            max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
            bound_ms=k["bound_ms"], bound_by=k["bound_by"],
            library_ms=k["library_ms"], shape=k["shape"],
            main_path_cell=f"lm_families {cell} forward",
            **{x: k[x] for x in ("variant", "device_ms", "host_us",
                                 "library", "max_abs_err_vs_library")}))
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
