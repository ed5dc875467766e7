"""The comparison that decides ``correct``: the engine's answers of the
window's calls against the plain reference, lane by lane.

A sample of each call's lanes, drawn from the seed (one lane from each of
``check_lanes_per_call`` equal blocks of the lane axis, so that every part
of the batch is looked at), is re-simulated by
:mod:`portbench.reference.des` from the same trace and parameters, and
each number below is the worst over the sampled lanes of every call:

* ``completion_gap``: a task's completion time, ``|got - want| /
  max(want, 1 s)``; a task finished, or rejected, on one side only reads
  ``inf``;
* ``events_gap``: the lane's event count, ``|got - want| / want``;
* ``t_end_gap``: the lane's end time, as a completion time;
* ``energy_gap``: each PM's energy, against ``max(want, the lane's median
  PM energy)``;
* ``meter_gap``: the rest of the meter stack (idle energy per PM, the IaaS
  total, the Eq. 6 energy of all VMs, the unattributed energy, the HVAC
  meter), each entry against ``max(want, the reading's median, 1 J)``.
  The Eq. 6 energy is compared slot by slot, the reference's taken into
  the slots that the engine gave each task: the reference records each
  task's VM energy and the engine its task's slot (``task_vm``).  Which
  slot a VM takes can differ between the two sides when two frees or two
  dispatches fall within rounding of each other, with every task, host and
  total unchanged; where the two sides' slots agree this is the reference's
  own reading of the slot.

A lane whose VM slots overflowed, on either side, is wrong.
"""
from __future__ import annotations

import multiprocessing
import os
from multiprocessing import resource_tracker

import numpy as np

from .reference import des

NUMBERS = ("completion_gap", "events_gap", "t_end_gap", "energy_gap",
           "meter_gap")
METERS = ("pm_idle", "iaas_total", "vm", "vm_unattributed", "hvac")


def sample_lanes(n_lanes: int, k: int, rng: np.random.RandomState):
    """One lane from each of ``k`` near-equal blocks of ``n_lanes``."""
    edges = np.linspace(0, n_lanes, min(k, n_lanes) + 1).astype(int)
    return [int(rng.randint(a, b)) for a, b in zip(edges[:-1], edges[1:])]


def _rel(got, want, floor):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    both = (got == want) | (np.isinf(got) & np.isinf(want))
    with np.errstate(invalid="ignore"):
        d = np.abs(got - want) / np.maximum(np.abs(want), floor)
    d = np.where(both, 0.0, d)
    d = np.where(np.isnan(d), np.inf, d)
    return float(d.max()) if d.size else 0.0


def _meter_gap(got, want) -> float:
    want = np.asarray(want, np.float64)
    return _rel(got, want, max(float(np.median(np.abs(want))), 1.0))


def vm_in_slots(task_energy, task_vm, n_vm: int) -> np.ndarray:
    """Each VM slot's energy: the energy of the tasks' VMs (one entry a
    task) summed into the slot that ``task_vm`` gives each task (-1: none,
    and then no energy may be left over)."""
    e = np.asarray(task_energy, np.float64)
    slot = np.asarray(task_vm, np.int64)
    out = np.bincount(slot[slot >= 0], weights=e[slot >= 0],
                      minlength=n_vm)
    if (e[slot < 0] != 0).any():
        out = np.full(n_vm, np.inf)
    return out


def lane_numbers(got: dict, want: dict) -> dict:
    """The numbers compared for one lane: ``got`` the engine's answers of
    the lane (its row of each array), ``want`` the reference's."""
    rg = got["readings"]
    rw = dict(want["readings"], vm=vm_in_slots(
        want["task_vm_energy"], got["task_vm"], len(rg["vm"])))
    pm_w = np.asarray(rw["pm"], np.float64)
    rejected = (np.asarray(got["rejected"], bool)
                != np.asarray(want["rejected"], bool)).any()
    out = dict(
        completion_gap=(float("inf") if rejected else
                        _rel(got["completion"], want["completion"], 1.0)),
        events_gap=_rel(got["n_events"], want["n_events"], 1.0),
        t_end_gap=_rel(got["t_end"], want["t_end"], 1.0),
        energy_gap=_rel(rg["pm"], pm_w, max(float(np.median(pm_w)), 1.0)),
        meter_gap=max(_meter_gap(rg[k], rw[k]) for k in METERS))
    if bool(got["overflow"]) or bool(want["overflow"]):
        out = {k: float("inf") for k in out}
    return out


def _simulate(job):
    config, point, trace, precision, max_passes = job
    return des.simulate(config, point, trace, precision=precision,
                        max_passes=max_passes)


def reference_answers(jobs, workers: int):
    """The reference's answers of ``jobs`` (``(config, point, trace,
    precision, max_passes)``), in worker processes when ``workers > 1``
    (spawned: they import NumPy and the reference alone)."""
    if workers <= 1 or len(jobs) <= 1:
        return [_simulate(j) for j in jobs]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(workers, len(jobs))) as pool:
        out = pool.map(_simulate, jobs, chunksize=1)
        pool.close()
        pool.join()
    # the pool started multiprocessing's resource tracker; end it and wait
    # for it, so that no process of the run outlives it
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()
    return out


def default_workers() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def lane_row(answers: dict, i: int) -> dict:
    """Lane ``i``'s answers from a call's batched answers."""
    return dict(completion=answers["completion"][i],
                rejected=answers["rejected"][i],
                n_events=answers["n_events"][i], t_end=answers["t_end"][i],
                overflow=answers["overflow"][i],
                task_vm=answers["task_vm"][i],
                readings={k: v[i] for k, v in answers["readings"].items()})


def compare(config: dict, calls, k: int, rng: np.random.RandomState, *,
            workers: int = 1):
    """The numbers compared, worst over the sampled lanes of ``calls``
    (each ``(lanes, traces, answers)``).  Returns ``(numbers, at)``,
    ``at`` the (call, lane) at which each number was read."""
    picks, jobs, where = [], [], []
    for c, (lanes, traces, answers) in enumerate(calls):
        for i in sample_lanes(len(lanes), k, rng):
            picks.append((answers, i))
            where.append((c, i))
            jobs.append((config, lanes[i].point, traces[lanes[i].trace],
                         "float64", None))
    wants = reference_answers(jobs, workers)
    per_lane = [lane_numbers(lane_row(a, i), w)
                for (a, i), w in zip(picks, wants)]
    worst = {n: max((p[n] for p in per_lane), default=0.0) for n in NUMBERS}
    at = {n: where[max(range(len(per_lane)), key=lambda j: per_lane[j][n])]
          for n in NUMBERS} if per_lane else {}
    return worst, at


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number within its limit."""
    return all(numbers[n] <= limits[n] for n in NUMBERS)
