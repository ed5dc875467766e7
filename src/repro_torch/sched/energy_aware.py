"""Energy-aware fleet scheduling of LM jobs (port of
``repro/sched/energy_aware.py``): the paper's purpose, closed over this
package's own workloads.

DISSECT-CF exists to "foster energy-aware scheduling in infrastructure
clouds"; here the infrastructure is a fleet of GPU nodes and the workloads
are the dry-run-characterised training and serving jobs of the ten LM
architectures:

1. :func:`load_cells` reads the dry run's records
   (:mod:`repro_torch.launch.dryrun`, or the reference's, which share the
   schema) and derives each cell's roofline step time (the largest of the
   compute, memory and collective terms on a :class:`Chip`) and its
   utilisation (compute term / step time);
2. :func:`job_trace` turns a job mix (arch x shape x steps) into a
   DISSECT-CF task trace: work is measured in chip-seconds, a "PM" is a
   node of ``chip.per_pm`` chips, a "VM request" is a job's node
   reservation (the image transfer models the staging of its weights);
3. :func:`evaluate_schedulers` sweeps the scheduler matrix (every
   registered VM x PM policy pair) through the tournament experiment
   (:mod:`repro_torch.experiments.tournament`, one batched
   ``simulate_batch`` call) and reports the meter stack's readings: IT
   energy, the job-attributed share, the unattributed idle waste and
   facility cooling, beside makespan and queueing.

Power model: each chip draws ``chip.idle_w`` idle and ``chip.peak_w`` at
full load, linear in utilisation (the paper's linear consumption model),
scaled to the node's chip count.  :data:`H100` is the default chip; the
reference's own figures can be passed as another :class:`Chip`.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from ..core import engine
from ..core.energy import PowerStateTable


@dataclasses.dataclass(frozen=True)
class Chip:
    """One accelerator's figures and the chips of one node (a PM)."""

    name: str
    peak_flops: float      # dense bf16 FLOP/s
    hbm_bw: float          # B/s
    link_bw: float         # B/s, one direction of the node's interconnect
    idle_w: float          # W, no work
    peak_w: float          # W, full load (the power limit)
    per_pm: int            # chips in one node


# NVIDIA H100 SXM5 (NVIDIA's datasheet: 989.4 TFLOP/s dense bf16, 3.35 TB/s
# HBM3, 900 GB/s NVLink both directions), 700 W, the card's power limit
# (nvidia-smi power.limit), 8 to an HGX H100 node.  idle_w: nvidia-smi's
# power.draw on an NVIDIA H100 80GB HBM3 at a 700.00 W limit with a CUDA
# context open and nothing queued, the median of five readings, as
# chip_smoke.py's fleet phase reads it (idle_draw_w) after its other
# phases.
H100 = Chip(name="NVIDIA H100 SXM5", peak_flops=989.4e12, hbm_bw=3.35e12,
            link_bw=450e9, idle_w=123.22, peak_w=700.0, per_pm=8)


@dataclasses.dataclass(frozen=True)
class CellPerf:
    arch: str
    shape: str
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def utilisation(self) -> float:
        return self.compute_s / max(self.step_s, 1e-30)


def roofline_terms(rec: dict, *, chip: Chip = H100
                   ) -> tuple[float, float, float]:
    """Per-device roofline seconds (compute, memory, collective) of one
    dry-run record on ``chip``."""
    hc = rec["hlo_cost"]
    compute = hc["dot_flops"] / chip.peak_flops
    memory = hc["bytes_accessed"] / chip.hbm_bw
    collective = hc["collective_total_bytes"] / chip.link_bw
    return compute, memory, collective


def load_cells(dryrun_dir: str | Path, mesh: str = "1x1", *,
               chip: Chip = H100) -> dict:
    """``{(arch, shape): CellPerf}`` of every counted record of ``mesh``
    under ``dryrun_dir`` (skipped and failed cells left out)."""
    cells = {}
    for path in Path(dryrun_dir).glob(f"*_{mesh}.json"):
        rec = json.loads(path.read_text())
        if not rec.get("ok") or rec.get("skipped") or "hlo_cost" not in rec:
            continue
        c, m, k = roofline_terms(rec, chip=chip)
        cells[(rec["arch"], rec["shape"])] = CellPerf(
            rec["arch"], rec["shape"], c, m, k)
    return cells


@dataclasses.dataclass(frozen=True)
class Job:
    arch: str
    shape: str
    steps: int
    pods: int = 1


def job_trace(jobs: list[Job], cells: dict, *, arrival_spread_s: float = 600.0,
              seed: int = 0, chip: Chip = H100) -> engine.Trace:
    """DISSECT-CF trace: one VM request per job (``job.pods`` nodes of
    ``chip.per_pm`` chips); work in chip-seconds.  numpy f32 arrays,
    sorted by arrival."""
    rng = np.random.RandomState(seed)
    arrivals, cores, work = [], [], []
    for job in jobs:
        perf = cells.get((job.arch, job.shape))
        if perf is None:
            continue
        chips = job.pods * chip.per_pm
        duration = perf.step_s * job.steps
        arrivals.append(rng.uniform(0.0, arrival_spread_s))
        cores.append(float(chips))
        # work is scaled by the job's utilisation so energy integration sees
        # realistic (not 100%) chip load
        work.append(duration * chips * max(perf.utilisation, 0.05))
    order = np.argsort(arrivals)
    return engine.Trace(arrival=np.asarray(arrivals, np.float32)[order],
                        cores=np.asarray(cores, np.float32)[order],
                        work=np.asarray(work, np.float32)[order])


def pod_power_table(*, chip: Chip = H100) -> PowerStateTable:
    """Linear node power model (paper Table 1 form, ``chip``'s figures
    times its chips a node)."""
    n = chip.per_pm
    return PowerStateTable.simple(
        off_w=0.05 * chip.idle_w * n, on_w=chip.idle_w * n,
        min_w=chip.idle_w * n, max_w=chip.peak_w * n,
        off_w2=chip.idle_w * n, boot_s=120.0, shutdown_s=30.0)


def fleet_params(*, vm_sched="firstfit", pm_sched="alwayson",
                 power: PowerStateTable | None = None,
                 chip: Chip = H100) -> engine.CloudParams:
    """The fleet's parameter point: one node is one PM of ``chip.per_pm``
    cores (a core is a chip)."""
    n = float(chip.per_pm)
    return engine.CloudParams(
        pm_cores=n, perf_core=1.0, image_mb=10_000.0, net_bw=2_000.0,
        repo_bw=8_000.0, boot_work=60.0 * n, vm_sched=vm_sched,
        pm_sched=pm_sched,
        power=power if power is not None else pod_power_table(chip=chip))


def evaluate_schedulers(trace: engine.Trace, *, n_pods: int = 8,
                        schedulers=None, sharded: bool = True,
                        chip: Chip = H100, devices=None) -> list[dict]:
    """Sweep the VM x PM scheduler matrix over one job trace on a fleet of
    ``n_pods`` nodes: one :func:`repro_torch.experiments.tournament.run`
    (every registered policy pair by default, 3 x 5 with the builtins, in
    one batch).  Runs on the GPU unless ``devices`` names the CPU
    (``devices=["cpu"]``).  Each row reports ``job_kwh`` / ``idle_kwh``
    from the per-VM Eq. 6 meters, so the migrating policies' rows show how
    much unattributed idle their moves shed."""
    from ..experiments import tournament
    if schedulers is None:
        schedulers = tournament.scheduler_grid()
    spec = engine.CloudSpec(n_pm=n_pods, n_vm=max(int(trace.n), 8))
    return tournament.run(spec, trace, fleet_params(chip=chip),
                          schedulers=schedulers, sharded=sharded,
                          devices=devices).rows


def default_job_mix(cells: dict, *, n_jobs: int = 24, seed: int = 0
                    ) -> list[Job]:
    """A mixed fleet: jobs drawn from the cells, of varied lengths."""
    rng = np.random.RandomState(seed)
    keys = sorted(cells.keys())
    jobs = []
    for _ in range(n_jobs):
        arch, shape = keys[rng.randint(len(keys))]
        steps = int(rng.choice([200, 500, 1000, 2000]))
        jobs.append(Job(arch=arch, shape=shape, steps=steps))
    return jobs
