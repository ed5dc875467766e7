"""The lane axis of the port's kernel modules and of the helpers the batched
engine reduces with, on the CPU.

Each wrapper takes one problem or B lanes of one shape ([B, C], [B, S]);
on the CPU it runs its plain version.  Every lane of the plain version must
equal the 1-D plain version on that lane's row bit for bit, and
``jax.vmap`` of the oracle in ``repro/kernels/ref.py`` (the reference's
batched path is ``vmap``) bit for bit.  The lanes come from
``repro_torch.kernels.maxmin_cases.lane_cases``, which ``chip_smoke.py``
also runs on the card, and from seeded random draws.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch import kernels
from repro_torch.core import arrays, influence
from repro_torch.kernels import horizon, maxmin
from repro_torch.kernels.maxmin_cases import lane_cases

LANE_CASES = lane_cases()
# the batch at the main path's width (B = 8, C = 4596, S = 6098) runs on the
# card in chip_smoke.py, against this plain version on the CPU; here the
# smaller batches cover the same lane mixes
CPU_CASES = [c for c in LANE_CASES if c.label != "main_path_4596x6098"]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _bits(x) -> bytes:
    return np.asarray(x).tobytes()


def _counted(round_fn, n: list):
    def run(*a):
        n.append(1)
        return round_fn(*a)
    return run


@pytest.mark.parametrize("case", CPU_CASES, ids=[c.label for c in CPU_CASES])
def test_solve_lanes_equal_their_rows_and_vmapped_oracle(case):
    """Each lane of the solve is its row's 1-D solve and ``jax.vmap`` of
    the oracle's; the route above the solve's gate (one plan, then one
    round at a time, one host read a round for all lanes) gives the same
    rates, in as many rounds as the lane that needs the most."""
    args = case.args()
    got = maxmin.maxmin_solve(*map(_t, args), max_iters=case.max_iters)
    assert got.shape == args[0].shape
    per_lane = []
    for b, lane in enumerate(case.lanes):
        n = []
        row = maxmin.progressive_filling(
            *map(_t, lane.args()), _counted(maxmin.fill_round_plain, n),
            plan_fn=maxmin.fill_plan_plain, max_iters=case.max_iters)
        assert _bits(got[b]) == _bits(row), lane.label
        per_lane.append(len(n))
    want = jax.vmap(lambda *a: ref.maxmin_solve_ref(
        *a, max_iters=case.max_iters))(*map(jnp.asarray, args))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rounds = []
    wise = maxmin.progressive_filling(
        *map(_t, args), _counted(maxmin.fill_round, rounds),
        max_iters=case.max_iters)
    assert _bits(wise) == _bits(got)
    assert len(rounds) == max(per_lane)


def _fill_lanes(B, C, S, seed):
    rng = np.random.RandomState(seed)
    prov = rng.randint(0, S, (B, C)).astype(np.int32)
    cons = rng.randint(0, S, (B, C)).astype(np.int32)
    r = rng.rand(B, C).astype(np.float32)
    live = rng.rand(B, C) < np.linspace(0.0, 0.9, B)[:, None]
    unfrozen = live & (rng.rand(B, C) < 0.7)
    perf = (rng.rand(B, S) * 10).astype(np.float32)
    return prov, cons, r, live, unfrozen, perf


@pytest.mark.parametrize("B,C,S,seed", [(1, 64, 16, 0), (4, 300, 40, 1),
                                        (3, 2000, 260, 2), (2, 9692, 900, 3)])
def test_fill_stats_lanes_equal_rows_and_vmapped_oracle(B, C, S, seed):
    args = _fill_lanes(B, C, S, seed)
    prov, cons, r, live, unfrozen, perf = map(_t, args)
    dp, dc = maxmin.fill_stats(prov, cons, r, live, unfrozen, perf)
    plan = maxmin.fill_plan(prov, cons, live, unfrozen, S)
    rp, rc = maxmin.fill_round(plan, r, live, unfrozen, perf)
    assert plan.off_p.shape == (B, S + 1) and plan.csr_c.shape == (B, C)
    for b in range(B):
        row = [x[b] for x in (prov, cons, r, live, unfrozen, perf)]
        plan_b = maxmin.fill_plan_plain(row[0], row[1], row[3], row[4], S)
        for got, want in zip(plan, plan_b):
            assert torch.equal(got[b], want)
        wp, wc = maxmin.fill_stats_plain(*row)
        for got, want in ((dp, wp), (dc, wc), (rp, wp), (rc, wc)):
            assert _bits(got[b]) == _bits(want)
    vp, vc = jax.vmap(ref.fill_stats_ref)(*map(jnp.asarray, args))
    np.testing.assert_array_equal(dp.numpy(), np.asarray(vp))
    np.testing.assert_array_equal(dc.numpy(), np.asarray(vc))
    assert plan.longest_segment() == max(
        int(np.diff(plan.off_p.numpy()).max()),
        int(np.diff(plan.off_c.numpy()).max()))


@pytest.mark.parametrize("B,N,seed", [(1, 9696, 0), (8, 9696, 1),
                                      (3, 65537, 2), (5, 7, 3)])
def test_masked_min_rows_equal_vectors_and_vmapped_oracle(B, N, seed):
    rng = np.random.RandomState(seed)
    cand = (rng.randn(B, N) * 100).astype(np.float32)
    mask = rng.rand(B, N) < 0.5
    mask[0] = False                        # an empty row: 3e38
    if B > 2:
        cand[2, 1] = np.nan                # a NaN masked in propagates
        mask[2, 1] = True
    got = horizon.masked_min(_t(cand), _t(mask))
    assert got.shape == (B,)
    for b in range(B):
        row = horizon.masked_min(_t(cand[b]), _t(mask[b]))
        assert row.dim() == 0
        assert _bits(got[b]) == _bits(row)
    want = jax.vmap(ref.masked_min_ref)(jnp.asarray(cand), jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got[0]) == float(np.float32(3e38))
    with pytest.raises(ValueError):
        horizon.masked_min(torch.zeros((B, 0)),
                          torch.zeros((B, 0), dtype=torch.bool))


def test_lane_inputs_take_the_plain_path_on_the_cpu_and_count_nothing():
    kernels.reset_launch_counts()
    args = tuple(map(_t, LANE_CASES[-1].args()))    # two lanes, 2 rounds
    maxmin.maxmin_solve(*args, max_iters=2)
    maxmin.progressive_filling(*args, maxmin.fill_round, max_iters=2)
    horizon.masked_min(torch.ones(4, 3), torch.ones(4, 3, dtype=torch.bool))
    assert set(kernels.launch_counts().values()) == {0}
    assert set(kernels.sub_launch_counts().values()) == {0}


def test_lane_shape_rules():
    """A wrapper takes one problem or [B, ...] lanes, B from 1 to the
    launch's limit; any other rank is refused before a kernel could run."""
    assert maxmin._lane_shape("x", torch.zeros(5)) == ()
    assert maxmin._lane_shape("x", torch.zeros(3, 5)) == (3,)
    for bad in (torch.zeros(2, 3, 5), torch.zeros(0, 5),
                torch.zeros(maxmin.MAX_LANES + 1, 1)):
        with pytest.raises(ValueError):
            maxmin._lane_shape("x", bad)


# ---------------------------------------------------------------------------
# the engine's lane helpers: each lane as the single lane, whatever B is
# ---------------------------------------------------------------------------

def test_segment_sum_and_scatter_drop_lanes_equal_single_lanes():
    rng = np.random.RandomState(9)
    B, M, n = 4, 500, 13
    ids = _t(rng.randint(0, n, (B, M)).astype(np.int32))
    keep = _t(rng.rand(B, M) < 0.4)
    data = torch.where(keep, _t(rng.rand(B, M).astype(np.float32)), 0.0)
    got = arrays.segment_sum(data, ids, n, where=keep)
    for b in range(B):
        one = arrays.segment_sum(data[b:b + 1], ids[b:b + 1], n,
                                 where=keep[b:b + 1])
        assert _bits(got[b]) == _bits(one[0])
        want = jax.ops.segment_sum(jnp.asarray(data[b].numpy()),
                                   jnp.asarray(ids[b].numpy()), n)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    dst = _t(rng.rand(B, n).astype(np.float32))
    idx = _t(rng.randint(0, n + 1, (B, 6)).astype(np.int32))
    src = _t(rng.rand(B, 6).astype(np.float32))
    out = arrays.scatter_drop(dst, idx, src)
    for b in range(B):
        want = dst[b].clone()
        for i, v in zip(idx[b].tolist(), src[b].tolist()):
            if i < n:
                want[i] = v
        assert torch.equal(out[b], want)
    assert torch.equal(dst, _t(dst.numpy()))   # left untouched


def test_lane_sum_reduces_each_lane_as_a_vector():
    rng = np.random.RandomState(10)
    x = _t((rng.rand(8, 777) * 1e3).astype(np.float32))
    got = arrays.lane_sum(x)
    assert got.shape == (8,)
    for b in range(8):
        assert _bits(got[b]) == _bits(x[b].sum(-1))
        assert _bits(arrays.lane_sum(x[b:b + 1])[0]) == _bits(x[b].sum())
    assert arrays.lane_sum(x[0]).dim() == 0


def test_influence_labels_lanes_equal_single_lanes():
    """The fixpoint runs until no lane changes; a settled lane is a fixed
    point of the extra rounds."""
    rng = np.random.RandomState(11)
    B, F, S = 5, 60, 40
    prov = _t(rng.randint(0, S, (B, F)).astype(np.int32))
    cons = _t(rng.randint(0, S, (B, F)).astype(np.int32))
    live = _t(rng.rand(B, F) < np.linspace(0.0, 0.9, B)[:, None])
    got = influence.influence_labels(prov, cons, live, S)
    for b in range(B):
        one = influence.influence_labels(prov[b:b + 1], cons[b:b + 1],
                                         live[b:b + 1], S)
        assert torch.equal(got[b], one[0])
    assert torch.equal(got[0], torch.arange(S, dtype=torch.int32))
