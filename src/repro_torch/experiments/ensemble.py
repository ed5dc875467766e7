"""Trace ensembles: the same policy grid across many seeded workloads
(port of ``repro.experiments.ensemble``).

Seed-perturbed trace replicates crossed with a list of parameter points
run as one batch through :func:`repro_torch.experiments.shard.run_batch`;
the meter-stack readings reduce to ``mean / std / ci`` a point.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

from ..core import engine
from ..core.trace import gwa_like_trace
from . import shard

# two-sided normal critical values for the supported confidence levels
_Z = {0.80: 1.2816, 0.90: 1.6449, 0.95: 1.9600, 0.99: 2.5758}


def gwa_ensemble(family: str, n_tasks: int, replicates: int, *,
                 pm_cores: float = 64.0, seed0: int = 0
                 ) -> list[engine.Trace]:
    """``replicates`` seed-perturbed GWA-like traces of one family, capped
    to ``pm_cores`` so every task fits a PM (equal lengths, as
    :func:`~repro_torch.core.engine.stack_traces` needs)."""
    return [gwa_like_trace(family, n_tasks, max_cores=int(pm_cores),
                           seed=seed0 + r)
            for r in range(replicates)]


def job_mix_ensemble(cells: dict, replicates: int, *, n_jobs: int = 24,
                     arrival_spread_s: float = 1800.0, seed0: int = 0
                     ) -> list[engine.Trace]:
    """Seed-perturbed fleet job mixes: not ported.  The reference draws
    them from ``repro.sched.energy_aware``, which reads the LM dry-run
    records of ROADMAP item 14.7."""
    raise NotImplementedError(
        "job_mix_ensemble needs sched.energy_aware, which is not ported to "
        "repro_torch yet (ROADMAP queue 1, item 12; it waits for the LM dry "
        "run of item 14.7)")


def _metric_table(spec: engine.CloudSpec, res: engine.CloudResult,
                  n: int) -> dict[str, np.ndarray]:
    """f64[B] a batch point for every reported ensemble metric."""
    readings = {k: v.cpu().numpy().astype(np.float64)
                for k, v in res.readings(spec).items()}
    metrics = {
        "energy_kwh": readings["iaas_total"] / 3.6e6,
        "makespan_s": res.t_end.cpu().numpy().astype(np.float64),
    }
    if "vm" in readings:
        metrics["job_kwh"] = readings["vm"].reshape(n, -1).sum(axis=1) / 3.6e6
        metrics["idle_kwh"] = readings["vm_unattributed"] / 3.6e6
    if "hvac" in readings:
        metrics["hvac_kwh"] = readings["hvac"] / 3.6e6
    return metrics


class EnsembleResult(NamedTuple):
    rows: list[dict]            # one row per parameter point (policy)
    result: engine.CloudResult  # full [points * replicates] engine result


def run_ensemble(spec: engine.CloudSpec, traces: Sequence[engine.Trace],
                 points: Sequence[engine.CloudParams], *,
                 labels: Sequence[dict] | None = None,
                 confidence: float = 0.95,
                 sharded: bool = True, devices=None) -> EnsembleResult:
    """Cross ``points`` (policies) with ``traces`` (workload replicates)
    into one batch of ``len(points) * len(traces)`` scenarios, then report
    per point ``<metric>_mean`` / ``<metric>_std`` / ``<metric>_ci`` (the
    half-width of the two-sided normal CI at ``confidence``) for the
    meter-stack energies and the makespan.

    Batch index ``p * R + r`` is point ``p`` on replicate ``r``."""
    if confidence not in _Z:
        raise ValueError(
            f"confidence must be one of {sorted(_Z)}, got {confidence}")
    points, traces = list(points), list(traces)
    n_p, n_r = len(points), len(traces)
    if n_r < 2:
        raise ValueError("an ensemble needs >= 2 trace replicates")
    batch_trace = engine.stack_traces([tr for _ in points for tr in traces])
    batch_params = engine.stack_params([p for p in points
                                       for _ in range(n_r)])
    res = shard.run_batch(spec, batch_trace, batch_params,
                          sharded=sharded, devices=devices)
    metrics = _metric_table(spec, res, n_p * n_r)
    z = _Z[confidence]
    rows = []
    for p in range(n_p):
        row = dict(labels[p]) if labels is not None else {"point": p}
        row["replicates"] = n_r
        row["confidence"] = confidence
        for name, vals in metrics.items():
            v = vals[p * n_r:(p + 1) * n_r]
            std = float(v.std(ddof=1))
            row[f"{name}_mean"] = float(v.mean())
            row[f"{name}_std"] = std
            row[f"{name}_ci"] = float(z * std / np.sqrt(n_r))
        rows.append(row)
    return EnsembleResult(rows=rows, result=res)
