"""Inputs of the fused max-min solve at its edges, made with numpy from
fixed seeds: one generator for the CPU tests (the plain version against the
JAX reference and the Pallas kernel) and for the card's checks in
``chip_smoke.py`` (the kernel against the plain version on the CPU).

Each case holds ``maxmin_solve``'s five inputs and the ``max_iters`` it is
solved under.  Together they cover: no live flow and every flow live; one
provider carrying every flow; flows whose provider is their consumer; ties
exactly at the freeze threshold and between two spreaders' headroom;
``p_l = 0`` and ``perf = 0``; ``p_l = inf``; a NaN in one live flow's
``p_l`` and in one touched spreader's ``perf``; flow counts that are no
multiple of 32 or 1024; live counts on both sides of the kernel's
shared-memory capacities (``SOLVE_SMEM_FLOWS``, ``SOLVE_HOT_FLOWS``) and
of its one-warp sort (32), and a few live flows among 4596 as on the main
path; and ``max_iters`` 1 and a solve that runs all 64 rounds.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .maxmin import SOLVE_HOT_FLOWS, SOLVE_SMEM_FLOWS


class SolveCase(NamedTuple):
    label: str
    provider: np.ndarray      # int32 [C], in [0, S)
    consumer: np.ndarray      # int32 [C], in [0, S)
    p_l: np.ndarray           # float32 [C]
    live: np.ndarray          # bool [C]
    perf: np.ndarray          # float32 [S]
    max_iters: int = 64

    def args(self) -> tuple:
        return (self.provider, self.consumer, self.p_l, self.live, self.perf)


def _random(label, C, S, seed, *, live_p=0.8, max_iters=64) -> SolveCase:
    rng = np.random.RandomState(seed)
    return SolveCase(
        label,
        provider=rng.randint(0, S, C).astype(np.int32),
        consumer=rng.randint(0, S, C).astype(np.int32),
        p_l=(rng.rand(C) * 4 + 0.1).astype(np.float32),
        live=rng.rand(C) < live_p,
        perf=(rng.rand(S) * 10).astype(np.float32),
        max_iters=max_iters)


def _with_live_count(case: SolveCase, n_live: int, seed: int) -> SolveCase:
    live = np.zeros(case.live.shape, bool)
    live[np.random.RandomState(seed).permutation(live.size)[:n_live]] = True
    return case._replace(live=live)


def _threshold_ties() -> SolveCase:
    """Round 1's delta is ``a``; the flows at ``thr(a)`` (the kernel's
    freeze threshold, rounded as it rounds) freeze with it, those one ulp
    above do not.  Flows 30-39 meet two spreaders of exactly equal
    headroom (5 / 5 each)."""
    C, S = 40, 8
    a = np.float32(0.7)
    thr = np.float32(np.float32(a * np.float32(1.0 + 1e-5))
                     + np.float32(1e-12))
    p_l = np.empty(C, np.float32)
    p_l[0:10] = a
    p_l[10:20] = thr
    p_l[20:30] = np.nextafter(thr, np.float32(np.inf))
    p_l[30:40] = np.inf
    provider = np.full(C, 0, np.int32)
    provider[30:35], provider[35:40] = 1, 2
    consumer = np.full(C, 3, np.int32)
    consumer[:30] = 4 + np.arange(30) % 4
    perf = np.full(S, 1.0e6, np.float32)
    perf[1] = perf[2] = 5.0
    return SolveCase("threshold_ties", provider, consumer, p_l,
                     np.ones(C, bool), perf)


def solve_cases() -> list[SolveCase]:
    """Every edge case, small enough for the Pallas kernel in interpret
    mode on the CPU."""
    cases = []
    base = _random("no_live", 300, 40, 20)
    cases.append(base._replace(live=np.zeros(300, bool)))
    cases.append(_random("all_live", 333, 50, 21)._replace(
        live=np.ones(333, bool)))
    # one provider with room for all, so that the consumers bind over
    # many rounds while its one long segment is summed in each
    for label, C, S, seed, live_p in (
            ("one_provider", 500, 60, 22, 0.9),
            # more live flows than shared memory holds
            ("one_provider_all_live_global", 2100, 100, 23, 1.0)):
        one = _random(label, C, S, seed, live_p=live_p)
        perf = one.perf.copy()
        perf[0] = 1.0e4
        cases.append(one._replace(provider=np.zeros(C, np.int32),
                                  perf=perf))
    same = _random("provider_is_consumer", 400, 50, 24)
    consumer = same.consumer.copy()
    consumer[::2] = same.provider[::2]
    cases.append(same._replace(consumer=consumer))
    cases.append(_threshold_ties())
    zero = _random("zero_p_l_and_perf", 256, 40, 25)
    p_l, perf = zero.p_l.copy(), zero.perf.copy()
    p_l[::5], perf[::4] = 0.0, 0.0
    cases.append(zero._replace(p_l=p_l, perf=perf))
    inf = _random("inf_p_l", 256, 40, 26)
    p_l = inf.p_l.copy()
    p_l[::3] = np.inf
    cases.append(inf._replace(p_l=p_l))
    nan = _random("nan_p_l_one_live_flow", 256, 40, 27)
    p_l = nan.p_l.copy()
    p_l[int(np.flatnonzero(nan.live)[7])] = np.nan
    cases.append(nan._replace(p_l=p_l))
    nan_perf = _random("nan_perf_touched_spreader", 256, 40, 39)
    perf = nan_perf.perf.copy()
    perf[nan_perf.provider[np.flatnonzero(nan_perf.live)[3]]] = np.nan
    cases.append(nan_perf._replace(perf=perf))
    cases.append(_random("max_iters_1", 1037, 150, 28, max_iters=1))
    cases.append(_random("all_64_rounds", 1500, 1700, 29))
    # live counts at the shared-memory capacity and one past it
    edge = _random("smem_capacity", 1100, 200, 30)
    cases.append(_with_live_count(edge, SOLVE_SMEM_FLOWS, 31))
    cases.append(_with_live_count(edge._replace(label="smem_capacity_plus_1"),
                                  SOLVE_SMEM_FLOWS + 1, 32))
    # past the hot arrays' capacity every array is in the workspace
    hot = _random("hot_capacity", 5200, 300, 40)
    cases.append(_with_live_count(hot, SOLVE_HOT_FLOWS, 41))
    cases.append(_with_live_count(hot._replace(label="hot_capacity_plus_1"),
                                  SOLVE_HOT_FLOWS + 1, 42))
    cases.append(_random("odd_width", 77, 13, 33))
    # few live flows, as on the main path: sorted by one warp (<= 32)
    sparse = _random("sparse_live", 4596, 6098, 34)
    for n_live, seed in ((1, 35), (14, 36), (32, 37), (33, 38)):
        cases.append(_with_live_count(
            sparse._replace(label=f"live_{n_live}_of_4596"), n_live, seed))
    return cases


class LaneCase(NamedTuple):
    """A batch of solves of one shape, one lane each (the lane axis of
    ``maxmin_solve``): each lane must equal the solve of its row alone."""
    label: str
    lanes: tuple              # SolveCase per lane, all of one (C, S)
    max_iters: int = 64

    def args(self) -> tuple:
        """Each argument stacked over the lanes: [B, C] / [B, S]."""
        return tuple(np.stack(xs) for xs in zip(*(c.args()
                                                   for c in self.lanes)))


def lane_cases() -> list[LaneCase]:
    """Batches whose lanes need different round counts and code paths:
    a lane with no live flow, lanes that freeze in one round and lanes
    that run many, NaN and inf lanes beside finite ones, and live counts
    on either side of the solve's shared-memory and hot-array capacities
    (each lane then in its own slice of the workspace)."""
    def lane(label, C, S, seed, n_live=None, **kw):
        case = _random(label, C, S, seed, **kw)
        return case if n_live is None else _with_live_count(case, n_live,
                                                            seed + 1)

    mixed = [lane("random", 300, 40, 50),
             lane("no_live", 300, 40, 51, n_live=0),
             lane("one_live", 300, 40, 52, n_live=1),
             lane("all_live", 300, 40, 53, live_p=1.0)]
    one = lane("one_provider", 300, 40, 54, live_p=0.9)
    perf = one.perf.copy()
    perf[0] = 1.0e4
    mixed.append(one._replace(provider=np.zeros(300, np.int32), perf=perf))
    odd = lane("inf_and_nan_p_l", 300, 40, 55)
    p_l = odd.p_l.copy()
    p_l[::3] = np.inf
    p_l[int(np.flatnonzero(odd.live)[5])] = np.nan
    mixed.append(odd._replace(p_l=p_l))
    hot = [lane("smem_plus_1", 5200, 300, 60, n_live=SOLVE_SMEM_FLOWS + 1),
           lane("sparse", 5200, 300, 62, n_live=14),
           lane("hot_plus_1", 5200, 300, 64, n_live=SOLVE_HOT_FLOWS + 1)]
    sparse = [lane(f"live_{n}", 4596, 6098, 70 + 2 * i, n_live=n)
              for i, n in enumerate((0, 1, 14, 32, 33, 16, 20, 200))]
    capped = [lane("capped_a", 1037, 150, 80), lane("capped_b", 1037, 150, 82)]
    return [LaneCase("mixed_300x40", tuple(mixed)),
            LaneCase("workspace_5200x300", tuple(hot)),
            LaneCase("main_path_4596x6098", tuple(sparse)),
            LaneCase("max_iters_2", tuple(capped), max_iters=2)]
