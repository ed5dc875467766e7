"""Sweep experiments on the batched engine (port of
``repro.experiments``).

Three experiment kinds, each one :func:`repro_torch.core.engine.
simulate_batch` call (split over devices by :mod:`.shard`):

* :mod:`~repro_torch.experiments.pareto`: parameter grids scored into
  energy-vs-makespan Pareto frontiers;
* :mod:`~repro_torch.experiments.ensemble`: seed-perturbed trace
  ensembles with per-policy mean and confidence intervals;
* :mod:`~repro_torch.experiments.tournament`: VM x PM scheduler grids;
* :mod:`~repro_torch.experiments.shard`: the lane split underneath all
  three, and the streamed batch (``shard.simulate_stream_batch``).

``ensemble.job_mix_ensemble`` waits for ``sched.energy_aware`` (ROADMAP
item 12).
"""
from . import ensemble, pareto, shard, tournament
from .ensemble import EnsembleResult, gwa_ensemble, run_ensemble
from .pareto import ParetoResult, param_grid, pareto_front, power_scale_grid
from .shard import run_batch, simulate_batch_sharded
from .tournament import TournamentResult, scheduler_grid

__all__ = [
    "ensemble", "pareto", "shard", "tournament",
    "EnsembleResult", "gwa_ensemble", "run_ensemble",
    "ParetoResult", "param_grid", "pareto_front", "power_scale_grid",
    "run_batch", "simulate_batch_sharded",
    "TournamentResult", "scheduler_grid",
]
