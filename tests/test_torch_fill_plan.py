"""The round-wise fair-share path of the port: a plan of the flows built once
per solve, then one round per call walked over it.

On the CPU ``fill_plan`` and ``fill_round`` run their plain versions (a
stable sort by segment; ``index_add_`` over the plan's order).  Both are
held bit for bit to ``fill_stats_plain`` and to ``ref.fill_stats_ref``, and
within rtol 1e-5 / atol 1e-6 to the Pallas ``fill_stats`` in interpret mode
(its one-hot contractions add in another order, so it is not bit-equal to
its own oracle); the whole round-wise solve bit for bit to the reference's
``maxmin_rates(backend="jnp")``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fairshare as jfair
from repro.kernels import ref
from repro.kernels.maxmin import fill_stats as pallas_fill_stats
from repro_torch import kernels
from repro_torch.kernels import maxmin

RTOL, ATOL = 1e-5, 1e-6


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _case(kind, C, S, seed):
    """Round inputs (provider, consumer, r, live, unfrozen, perf)."""
    rng = np.random.RandomState(seed)
    prov = rng.randint(0, S, C).astype(np.int32)
    cons = rng.randint(0, S, C).astype(np.int32)
    r = rng.rand(C).astype(np.float32)
    live = rng.rand(C) < 0.8
    unfrozen = live & (rng.rand(C) < 0.7)
    perf = (rng.rand(S) * 10).astype(np.float32)
    if kind == "unfrozen_not_in_live":
        unfrozen = rng.rand(C) < 0.5          # some unfrozen flows not live
        assert (unfrozen & ~live).any()
    elif kind == "negative_zero_r":
        r[rng.rand(C) < 0.4] = -0.0
        r[::7] = 0.0
    elif kind == "no_flow_live":
        live[:] = False
        unfrozen[:] = False
    elif kind == "one_spreader_owns_most":
        prov[rng.rand(C) < 0.9] = 3
        cons[rng.rand(C) < 0.8] = S - 1
    return prov, cons, r, live, unfrozen, perf


CASES = ([("random", C, S, seed) for C, S, seed in
          [(8, 4, 0), (64, 16, 1), (300, 40, 2), (1024, 128, 3),
           (2000, 260, 4)]]
         + [(kind, 700, 90, 10 + i) for i, kind in enumerate(
             ("unfrozen_not_in_live", "negative_zero_r", "no_flow_live",
              "one_spreader_owns_most"))])


@pytest.mark.parametrize("kind,C,S,seed", CASES)
def test_round_on_plan_is_bit_equal_to_fill_stats(kind, C, S, seed):
    args = _case(kind, C, S, seed)
    prov, cons, r, live, unfrozen, perf = map(torch.from_numpy, args)
    plan = maxmin.fill_plan_plain(prov, cons, live, unfrozen, S)
    got = maxmin.fill_round_plain(plan, r, live, unfrozen, perf)
    # the wrappers route CPU tensors to the same plain versions
    wrapped = maxmin.fill_round(maxmin.fill_plan(prov, cons, live, unfrozen,
                                                 S), r, live, unfrozen, perf)
    plain = maxmin.fill_stats_plain(prov, cons, r, live, unfrozen, perf)
    want_ref = ref.fill_stats_ref(*map(jnp.asarray, args))
    want_pl = pallas_fill_stats(*map(jnp.asarray, args), interpret=True)
    for g, w, p, pl, wr in zip(got, wrapped, plain, want_pl, want_ref):
        np.testing.assert_array_equal(_bits(g), _bits(p))
        np.testing.assert_array_equal(_bits(g), _bits(w))
        np.testing.assert_array_equal(_bits(g), _bits(wr))
        np.testing.assert_allclose(g.numpy(), np.asarray(pl), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("kind,C,S,seed", CASES)
def test_plan_is_a_stable_csr_of_the_contributing_flows(kind, C, S, seed):
    prov, cons, _, live, unfrozen, _ = map(torch.from_numpy,
                                           _case(kind, C, S, seed))
    plan = maxmin.fill_plan_plain(prov, cons, live, unfrozen, S)
    keep = np.flatnonzero((live | unfrozen).numpy())
    for off, csr, ids in ((plan.off_p, plan.csr_p, prov),
                          (plan.off_c, plan.csr_c, cons)):
        off, csr, ids = off.numpy(), csr.numpy(), ids.numpy()
        assert off.shape == (S + 1,) and off[0] == 0
        assert off[-1] == keep.size and np.all(np.diff(off) >= 0)
        assert sorted(csr[:off[-1]].tolist()) == keep.tolist()
        for s in range(S):
            seg = csr[off[s]:off[s + 1]]
            assert np.all(ids[seg] == s) and np.all(np.diff(seg) > 0)
    # built from live alone, the plan holds the live flows only
    live_plan = maxmin.fill_plan_plain(prov, cons, live, None, S)
    assert int(live_plan.off_p[-1]) == int(live.sum())


def test_longest_segment():
    prov, cons, _, live, unfrozen, _ = map(torch.from_numpy, _case(
        "one_spreader_owns_most", 700, 90, 13))
    plan = maxmin.fill_plan_plain(prov, cons, live, unfrozen, 90)
    keep = (live | unfrozen).numpy()
    want = max(np.bincount(prov.numpy()[keep], minlength=90).max(),
               np.bincount(cons.numpy()[keep], minlength=90).max())
    assert plan.longest_segment() == want > 500


@pytest.mark.parametrize("seed,skew", [(21, False), (22, False), (23, True)])
def test_round_wise_solve_through_the_plan_matches_reference(seed, skew):
    """Above the fused solve's gate: one plan, then a round per call, equal
    bit for bit to the reference's round-wise jnp solve."""
    C, S = 400, maxmin.MAX_SOLVE_S + 64
    rng = np.random.RandomState(seed)
    provider = rng.randint(0, S, C).astype(np.int32)
    consumer = rng.randint(S // 2, S, C).astype(np.int32)
    if skew:
        provider[rng.rand(C) < 0.6] = 5
    p_l = (rng.rand(C) * 3 + 0.05).astype(np.float32)
    live = rng.rand(C) < 0.9
    perf = (rng.rand(S) * 8).astype(np.float32)
    args = (provider, consumer, p_l, live, perf)
    plans, rounds = [], []

    def plan_fn(*a):
        plans.append(1)
        return maxmin.fill_plan(*a)

    def round_fn(*a):
        rounds.append(1)
        return maxmin.fill_round(*a)

    got = maxmin.progressive_filling(*map(torch.from_numpy, args), round_fn,
                                     plan_fn=plan_fn)
    want = jfair.maxmin_rates(*map(jnp.asarray, args), backend="jnp")
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert len(plans) == 1 and len(rounds) > 1


def test_no_live_flow_builds_no_plan():
    C, S = 32, 8
    z = torch.zeros((C,), dtype=torch.int32)
    none = torch.zeros((C,), dtype=torch.bool)
    plans = []
    got = maxmin.progressive_filling(
        z, z, torch.ones(C), none, torch.ones(S), maxmin.fill_round,
        plan_fn=lambda *a: plans.append(1))
    assert not plans and torch.equal(got, torch.zeros(C))


def test_plain_plan_and_round_count_no_launches():
    kernels.reset_launch_counts()
    prov, cons, r, live, unfrozen, perf = map(torch.from_numpy,
                                              _case("random", 64, 16, 1))
    maxmin.fill_round(maxmin.fill_plan(prov, cons, live, unfrozen, 16), r,
                      live, unfrozen, perf)
    maxmin.fill_stats(prov, cons, r, live, unfrozen, perf)
    assert kernels.sub_launch_counts() == {"flash_attention_mma": 0,
                                           "flash_attention_wgmma": 0,
                                           "fill_plan": 0}
    assert kernels.launch_counts()["fill_stats"] == 0


def test_plan_and_round_reject_devices_without_a_path():
    z = torch.zeros((4,), dtype=torch.int32, device="meta")
    b = torch.zeros((4,), dtype=torch.bool, device="meta")
    f = torch.zeros((4,), device="meta")
    with pytest.raises(ValueError):
        maxmin.fill_plan(z, z, b, None, 4)
    plan = maxmin.FillPlan(z, z, z, z)
    with pytest.raises(ValueError):
        maxmin.fill_round(plan, f, b, b, f)


def test_plan_shared_memory_gate():
    """Up to MAX_PLAN_SMEM_S spreaders the plan's two count vectors fit one
    block's shared memory beside its staged flows and static scratch;
    above, global scratch."""
    S = maxmin.MAX_PLAN_SMEM_S
    fixed = maxmin.STATIC_SMEM + maxmin.PLAN_STAGE_BYTES
    assert 8 * (S + 1) + fixed <= maxmin.SMEM_LIMIT
    assert 8 * (S + 2) + fixed > maxmin.SMEM_LIMIT
    # the above-gate cell (1500 PM x 8192 VM) plans in shared memory
    assert 4 * 1500 + 2 + 8192 <= S
