"""The port's kernel modules against the JAX package's kernels.

Inputs are made with numpy from a seed and fed to both packages.  On the
CPU each port wrapper runs its plain PyTorch version; it is held against
the Pallas kernel in interpret mode (called as tests/test_kernels.py calls
it) and against the pure-jnp oracle in repro/kernels/ref.py.  Tolerance:
floats rtol 1e-5 / atol 1e-6, the masked min exactly.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fairshare as jfair
from repro.kernels import ref
from repro.kernels.horizon import NB
from repro.kernels.horizon import masked_min as pallas_masked_min
from repro.kernels.maxmin import fill_stats as pallas_fill_stats
from repro.kernels.maxmin import maxmin_solve as pallas_maxmin_solve
from repro_torch.core import fairshare as tfair
from repro_torch.kernels import horizon, maxmin

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _flows(C, S, seed, live_p=0.8):
    rng = np.random.RandomState(seed)
    return dict(
        provider=rng.randint(0, S, C).astype(np.int32),
        consumer=rng.randint(0, S, C).astype(np.int32),
        r=rng.rand(C).astype(np.float32),
        p_l=(rng.rand(C) * 4 + 0.1).astype(np.float32),
        live=rng.rand(C) < live_p,
        unfrozen_draw=rng.rand(C) < 0.7,
        perf=(rng.rand(S) * 10).astype(np.float32))


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# fill_stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,S,seed", [(8, 4, 0), (64, 16, 1), (300, 40, 2),
                                      (1024, 128, 3), (2000, 260, 4)])
def test_fill_stats_matches_pallas_and_ref(C, S, seed):
    f = _flows(C, S, seed)
    unfrozen = f["live"] & f["unfrozen_draw"]
    args = (f["provider"], f["consumer"], f["r"], f["live"], unfrozen,
            f["perf"])
    dp, dc = maxmin.fill_stats(*map(_t, args))
    want_ref = ref.fill_stats_ref(*map(_j, args))
    want_pl = pallas_fill_stats(*map(_j, args), interpret=True)
    for got, wr, wp in zip((dp, dc), want_ref, want_pl):
        _close(got, wr)
        _close(got, wp)
        # same terms added in the same order as jax.ops.segment_sum
        np.testing.assert_array_equal(got.numpy(), np.asarray(wr))


def test_fill_stats_degenerate_empty():
    C, S = 16, 8
    z = np.zeros((C,), np.int32)
    none = np.zeros((C,), bool)
    args = (z, z, np.zeros((C,), np.float32), none, none,
            np.ones((S,), np.float32))
    dp, dc = maxmin.fill_stats(*map(_t, args))
    want = ref.fill_stats_ref(*map(_j, args))
    _close(dp, want[0])
    _close(dc, want[1])
    np.testing.assert_array_equal(dp.numpy(), np.full((S,), 3e38, np.float32))


# ---------------------------------------------------------------------------
# fused maxmin solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,S,seed", [(8, 4, 0), (64, 16, 1), (300, 40, 2),
                                      (1024, 130, 3), (128, 258, 5),
                                      (129, 258, 6)])
def test_maxmin_solve_matches_pallas_and_ref(C, S, seed):
    f = _flows(C, S, seed)
    args = (f["provider"], f["consumer"], f["p_l"], f["live"], f["perf"])
    got = maxmin.maxmin_solve(*map(_t, args))
    want = ref.maxmin_solve_ref(*map(_j, args))
    _close(got, want)
    _close(got, pallas_maxmin_solve(*map(_j, args), interpret=True))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_maxmin_solve_degenerate_empty():
    C, S = 16, 8
    z = torch.zeros((C,), dtype=torch.int32)
    none = torch.zeros((C,), dtype=torch.bool)
    got = maxmin.maxmin_solve(z, z, torch.ones(C), none, torch.ones(S))
    np.testing.assert_array_equal(got.numpy(), np.zeros((C,), np.float32))


def test_maxmin_solve_max_iters_caps_rounds():
    f = _flows(300, 40, 9)
    args = (f["provider"], f["consumer"], f["p_l"], f["live"], f["perf"])
    for iters in (1, 2, 5):
        got = maxmin.maxmin_solve(*map(_t, args), max_iters=iters)
        want = ref.maxmin_solve_ref(*map(_j, args), max_iters=iters)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_solve_gate_is_set_by_shared_memory():
    """The gate is the largest S whose solve footprint fits one block."""
    S = maxmin.MAX_SOLVE_S
    assert (maxmin.solve_smem_bytes(S) + maxmin.STATIC_SMEM
            <= maxmin.SMEM_LIMIT)
    assert (maxmin.solve_smem_bytes(S + 1) + maxmin.STATIC_SMEM
            > maxmin.SMEM_LIMIT)
    assert maxmin.solve_fits(10 ** 6, S) and not maxmin.solve_fits(8, S + 1)
    # the main path's full-width cloud (500 PM x 4096 VM) lies below it
    assert maxmin.solve_fits(4596, 4 * 500 + 2 + 4096)


@pytest.mark.parametrize("above_gate", [False, True])
def test_maxmin_rates_matches_reference(above_gate, monkeypatch):
    """The engine-facing maxmin_rates: one fused solve below the gate, the
    round-wise fill_stats loop above it; both equal the reference's."""
    C = 300
    S = maxmin.MAX_SOLVE_S + 64 if above_gate else 200
    rng = np.random.RandomState(7)
    provider = rng.randint(0, S, C).astype(np.int32)
    consumer = rng.randint(S // 2, S, C).astype(np.int32)
    p_l = (rng.rand(C) * 3 + 0.05).astype(np.float32)
    live = rng.rand(C) < 0.9
    perf = (rng.rand(S) * 8).astype(np.float32)
    rounds = []

    def counting_fill_stats(*a):
        rounds.append(1)
        return maxmin.fill_stats_plain(*a)

    monkeypatch.setattr(maxmin, "fill_stats", counting_fill_stats)
    args = (provider, consumer, p_l, live, perf)
    got = tfair.maxmin_rates(*map(_t, args))
    want = jfair.maxmin_rates(*map(_j, args), backend="jnp")
    _close(got, want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(rounds) == above_gate


def test_equal_share_rates_matches_reference():
    f = _flows(200, 30, 11)
    args = (f["provider"], f["consumer"], f["p_l"], f["live"], f["perf"])
    got = tfair.equal_share_rates(*map(_t, args))
    want = jfair.equal_share_rates(*map(_j, args))
    _close(got, want)


# ---------------------------------------------------------------------------
# event-horizon masked min
# ---------------------------------------------------------------------------

def _masked_min_both(cand, mask):
    got = horizon.masked_min(_t(cand), _t(mask))
    assert got.dim() == 0
    want_ref = ref.masked_min_ref(_j(cand), _j(mask))
    want_pl = pallas_masked_min(_j(cand), _j(mask), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_pl))
    return float(got)


@pytest.mark.parametrize("N,seed", [(1, 0), (7, 1), (128, 2), (1025, 3),
                                    (5000, 4)])
def test_masked_min_matches_pallas_and_ref(N, seed):
    rng = np.random.RandomState(seed)
    _masked_min_both((rng.randn(N) * 100).astype(np.float32),
                     rng.rand(N) < 0.6)


def test_masked_min_empty_mask_is_big():
    got = _masked_min_both(np.arange(10, dtype=np.float32),
                           np.zeros((10,), bool))
    assert got == float(np.float32(3.0e38))


def test_masked_min_infinite_unmasked_lanes():
    got = _masked_min_both(np.asarray([np.inf, 3.5, np.inf, 2.0], np.float32),
                           np.asarray([False, True, False, True]))
    assert got == 2.0


@pytest.mark.parametrize("N", [3, 277, NB - 1, NB, NB + 1,
                               2 * NB - 1, 2 * NB, 2 * NB + 1])
def test_masked_min_block_boundaries(N):
    rng = np.random.RandomState(N)
    _masked_min_both((rng.randn(N) * 50).astype(np.float32),
                     rng.rand(N) < 0.5)


@pytest.mark.parametrize("N", [5, NB, NB + 1, 2 * NB])
def test_masked_min_all_masked_is_big(N):
    got = _masked_min_both(np.linspace(-1e6, 1e6, N).astype(np.float32),
                           np.zeros((N,), bool))
    assert got == float(np.float32(3.0e38))


@pytest.mark.parametrize("N", [NB, NB + 1, 2 * NB])
def test_masked_min_single_lane_survivor_at_block_edge(N):
    cand = np.full((N,), 7.5, np.float32)
    cand[NB - 1] = -3.25
    mask = np.zeros((N,), bool)
    mask[NB - 1] = True
    assert _masked_min_both(cand, mask) == -3.25


# ---------------------------------------------------------------------------
# routing: the tensor's device picks kernel or plain version
# ---------------------------------------------------------------------------

def test_wrappers_reject_devices_without_a_path():
    z = torch.zeros((4,), dtype=torch.int32, device="meta")
    f = torch.zeros((4,), device="meta")
    b = torch.zeros((4,), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        maxmin.maxmin_solve(z, z, f, b, f)
    with pytest.raises(ValueError):
        maxmin.fill_stats(z, z, f, b, b, f)
    with pytest.raises(ValueError):
        horizon.masked_min(f, b)


def test_plain_path_counts_no_launches():
    from repro_torch import kernels
    kernels.reset_launch_counts()
    f = _flows(64, 16, 1)
    maxmin.maxmin_solve(*map(_t, (f["provider"], f["consumer"], f["p_l"],
                                  f["live"], f["perf"])))
    horizon.masked_min(torch.ones(3), torch.ones(3, dtype=torch.bool))
    assert kernels.launch_counts() == {"maxmin_solve": 0, "fill_stats": 0,
                                       "masked_min": 0}
