"""The readings that the limits of ``correct`` are set from, for one cell,
in one process on the card:

* the program: one sweep call on each of ``--seeds`` seeds, ``--lanes``
  sampled lanes of each compared with the float64 reference;
* the control: the reference computed in bfloat16, put in the program's
  place, on the same lanes of the first ``--control`` seeds.

    PYTHONPATH=src python3 -m portbench.calibrate --workload <cell> --seeds 12 --control 3

Prints one JSON line: every number's worst reading over the program's
seeds (the lower reading) and its smallest over the control's (the upper
reading), with the readings of each seed.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

from . import check, harness, traffic


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--lanes", type=int, default=16)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 1000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from . import system
    cell = harness.load_cell(args.workload)
    config, mix = cell.config, cell.mix
    lanes = traffic.lanes(config, mix)
    sweep = system.Sweep(config, lanes, args.device)
    workers = check.default_workers()
    program, control = [], []
    for j in range(args.seeds):
        seed = args.first_seed + 7919 * j
        traces = traffic.call_traces(config, mix, seed, 0)
        t = time.perf_counter()
        answers = sweep.answers(sweep.call(traces))
        call_s = time.perf_counter() - t
        rng = np.random.RandomState(seed % 2 ** 32)
        picks = check.sample_lanes(len(lanes), args.lanes, rng)
        jobs = [(config, lanes[i].point, traces[lanes[i].trace], "float64",
                 None) for i in picks]
        wants = check.reference_answers(jobs, workers)
        got = [check.lane_numbers(check.lane_row(answers, i), w)
               for i, w in zip(picks, wants)]
        program.append(dict(seed=seed, call_s=call_s,
                            events=int(answers["n_events"].sum()),
                            worst={n: max(g[n] for g in got)
                                   for n in check.NUMBERS}))
        print(json.dumps(program[-1]), file=sys.stderr, flush=True)
        if j < args.control:
            # the reference in bfloat16 in the program's place; a lane
            # that runs past ten times the events of the float64 one is
            # cut there (its unfinished tasks then read inf)
            cjobs = [(config, lanes[i].point, traces[lanes[i].trace],
                      "bfloat16", 10 * int(w["n_events"]))
                     for i, w in zip(picks, wants)]
            cgot = check.reference_answers(cjobs, workers)
            nums = [check.lane_numbers(
                dict(c, overflow=False, n_events=np.int64(c["n_events"])), w)
                for c, w in zip(cgot, wants)]
            control.append(dict(seed=seed, worst={
                n: max(x[n] for x in nums) for n in check.NUMBERS},
                least={n: min(x[n] for x in nums) for n in check.NUMBERS}))
            print(json.dumps(control[-1]), file=sys.stderr, flush=True)
    out = dict(
        workload=args.workload,
        lower={n: max(p["worst"][n] for p in program) for n in check.NUMBERS},
        upper={n: min(c["worst"][n] for c in control)
               for n in check.NUMBERS} if control else {},
        program=program, control=control)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
