"""The fused max-min solve at its edges, and the masked min on views and on
an empty vector, the port against the JAX package.

The cases come from ``repro_torch.kernels.maxmin_cases``, the generator
that ``chip_smoke.py`` also runs on the card.  On the CPU the port's
``maxmin_solve`` is its plain version; each case must equal
``ref.maxmin_solve_ref`` bit for bit, and the Pallas ``maxmin_solve`` in
interpret mode within rtol 1e-5 / atol 1e-6 (its one-hot contractions add
a segment's terms in another order).  The masked min is held exactly.
"""
from __future__ import annotations

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.horizon import masked_min as pallas_masked_min
from repro.kernels.maxmin import maxmin_solve as pallas_maxmin_solve
from repro_torch.kernels import horizon, maxmin
from repro_torch.kernels.maxmin_cases import solve_cases

RTOL, ATOL = 1e-5, 1e-6
CASES = solve_cases()
BY_LABEL = {c.label: c for c in CASES}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _rounds(case) -> tuple[np.ndarray, int]:
    """The plain solve's rates and the number of rounds it ran."""
    n = []

    def counting_round(*a):
        n.append(1)
        return maxmin.fill_round_plain(*a)

    r = maxmin.progressive_filling(*map(_t, case.args()), counting_round,
                                   plan_fn=maxmin.fill_plan_plain,
                                   max_iters=case.max_iters)
    return r.numpy(), len(n)


@pytest.mark.parametrize("case", CASES, ids=[c.label for c in CASES])
def test_solve_case_matches_reference_and_pallas(case):
    got = maxmin.maxmin_solve(*map(_t, case.args()),
                              max_iters=case.max_iters).numpy()
    want = ref.maxmin_solve_ref(*map(jnp.asarray, case.args()),
                                max_iters=case.max_iters)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(
        got, maxmin.maxmin_solve_plain(*map(_t, case.args()),
                                       max_iters=case.max_iters).numpy())
    pallas = pallas_maxmin_solve(*map(jnp.asarray, case.args()),
                                 max_iters=case.max_iters, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=RTOL, atol=ATOL)
    assert got.dtype == np.float32 and got.shape == case.p_l.shape
    assert np.isfinite(got).all()
    assert (got[~case.live] == 0).all()


def test_cases_cover_what_the_generator_names():
    live = {c.label: int(c.live.sum()) for c in CASES}
    assert live["no_live"] == 0
    assert live["all_live"] == BY_LABEL["all_live"].live.size
    assert live["smem_capacity"] == maxmin.SOLVE_SMEM_FLOWS
    assert live["smem_capacity_plus_1"] == maxmin.SOLVE_SMEM_FLOWS + 1
    assert live["one_provider_all_live_global"] > maxmin.SOLVE_SMEM_FLOWS
    assert live["hot_capacity"] == maxmin.SOLVE_HOT_FLOWS
    assert live["hot_capacity_plus_1"] == maxmin.SOLVE_HOT_FLOWS + 1
    for n in (1, 14, 32, 33):
        assert live[f"live_{n}_of_4596"] == n
    assert (BY_LABEL["one_provider"].provider == 0).all()
    same = BY_LABEL["provider_is_consumer"]
    assert (same.provider == same.consumer).sum() >= same.live.size // 2
    zero = BY_LABEL["zero_p_l_and_perf"]
    assert (zero.p_l == 0).any() and (zero.perf == 0).any()
    assert np.isposinf(BY_LABEL["inf_p_l"].p_l).any()
    nan = BY_LABEL["nan_p_l_one_live_flow"]
    assert np.isnan(nan.p_l).sum() == 1 and nan.live[np.isnan(nan.p_l)].all()
    nan_perf = BY_LABEL["nan_perf_touched_spreader"]
    bad = np.flatnonzero(np.isnan(nan_perf.perf))
    assert bad.size == 1 and (nan_perf.provider[nan_perf.live] == bad).any()
    assert any(c.provider.size % 32 and c.provider.size % 1024 for c in CASES)
    assert BY_LABEL["max_iters_1"].max_iters == 1
    assert all(c.provider.dtype == np.int32 and c.perf.dtype == np.float32
               for c in CASES)


@pytest.mark.parametrize("label,rounds", [
    ("no_live", 0), ("max_iters_1", 1), ("all_64_rounds", 64),
    ("one_provider", 64), ("one_provider_all_live_global", 64),
    ("nan_p_l_one_live_flow", 64), ("nan_perf_touched_spreader", 64),
    ("threshold_ties", 3),
    ("live_14_of_4596", 14)])
def test_solve_case_runs_its_rounds(label, rounds):
    assert _rounds(BY_LABEL[label])[1] == rounds


def test_threshold_ties_freeze_exactly_at_the_threshold():
    """After round 1 the flows at ``a`` and at ``thr(a)`` are frozen at
    ``a``; those one ulp above the threshold are raised again in round 2;
    the two spreaders of equal headroom freeze their flows together."""
    case = BY_LABEL["threshold_ties"]
    a = case.p_l[0]
    one = maxmin.maxmin_solve(*map(_t, case.args()), max_iters=1).numpy()
    two = maxmin.maxmin_solve(*map(_t, case.args()), max_iters=2).numpy()
    assert (one == a).all()
    assert (two[:20] == a).all() and (two[20:30] > a).all()
    assert (two[30:] == two[30]).all() and two[30] > a
    full, _ = _rounds(case)
    np.testing.assert_array_equal(full[20:30], case.p_l[20:30])


def test_nan_p_l_stalls_the_solve_as_the_reference_does():
    """A NaN headroom makes every round's min NaN, so delta falls back to
    0 and no flow moves: all rates stay 0, in the port and the reference."""
    got, rounds = _rounds(BY_LABEL["nan_p_l_one_live_flow"])
    assert rounds == 64 and (got == 0).all()


def test_nan_perf_stalls_the_solve_as_the_reference_does():
    """A NaN ``perf`` on a touched spreader makes its headroom NaN
    (``clamp_min`` passes NaN on), so every round's min is NaN and all rates
    stay 0, as for a NaN ``p_l``."""
    got, rounds = _rounds(BY_LABEL["nan_perf_touched_spreader"])
    assert rounds == 64 and (got == 0).all()


@pytest.mark.parametrize("case", CASES, ids=[c.label for c in CASES])
def test_round_wise_route_matches_the_fused_solve(case):
    """The engine's round-wise route (one ``fill_plan``, then a
    ``fill_round`` a round, as ``maxmin_rates`` runs above the gate) gives
    the reference's rates on every case, as the fused solve does."""
    rounds = maxmin.progressive_filling(*map(_t, case.args()),
                                        maxmin.fill_round,
                                        max_iters=case.max_iters)
    want = ref.maxmin_solve_ref(*map(jnp.asarray, case.args()),
                                max_iters=case.max_iters)
    np.testing.assert_array_equal(rounds.numpy(), np.asarray(want))


def test_thr_scale_rounds_as_the_plain_product():
    delta = torch.tensor(0.37, dtype=torch.float32)
    scale = maxmin._thr_scale(1e-5)
    assert scale == float(np.float32(1.0 + 1e-5))
    assert float(delta * (1.0 + 1e-5)) == float(np.float32(0.37) *
                                                np.float32(scale))


def test_smem_capacity_matches_the_kernel_source():
    src = (pathlib.Path(maxmin.__file__).resolve().parent.parent / "csrc"
           / "maxmin.cu").read_text()
    for name in ("SOLVE_SMEM_FLOWS", "SOLVE_HOT_FLOWS"):
        m = re.search(rf"#define {name} (\d+)", src)
        assert m and int(m.group(1)) == getattr(maxmin, name), name


def test_masked_min_grid_constants_match_the_kernel_source():
    src = (pathlib.Path(horizon.__file__).resolve().parent.parent / "csrc"
           / "horizon.cu").read_text()

    def define(name):
        m = re.search(rf"#define {name} (\d+)", src)
        assert m, name
        return int(m.group(1))

    assert define("SINGLE_BLOCK_LANES") == horizon.SINGLE_BLOCK_LANES
    assert horizon.WORKSPACE_BYTES == 4 * (1 + define("MAX_BLOCKS"))


# ---------------------------------------------------------------------------
# masked min: views that start off a 16-byte boundary, and the empty vector
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,c_off,m_off", [(1, 1, 1), (9696, 1, 1),
                                           (9696, 1, 0), (9696, 3, 7),
                                           (4097, 2, 5), (33, 0, 9)])
def test_masked_min_on_misaligned_views(N, c_off, m_off):
    rng = np.random.RandomState(N + c_off)
    cand_base = _t((rng.randn(N + 8) * 100).astype(np.float32))
    mask_base = _t(rng.rand(N + 16) < 0.6)
    cand = cand_base[c_off:c_off + N]
    mask = mask_base[m_off:m_off + N]
    assert cand.storage_offset() == c_off and cand.is_contiguous()
    got = horizon.masked_min(cand, mask)
    assert got.dim() == 0
    c, m = cand.numpy().copy(), mask.numpy().copy()
    want = ref.masked_min_ref(jnp.asarray(c), jnp.asarray(m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(pallas_masked_min(jnp.asarray(c),
                                                  jnp.asarray(m),
                                                  interpret=True)))


def test_masked_min_of_an_empty_vector_raises_as_its_oracle():
    """The plain version and ``ref.masked_min_ref`` have no identity for an
    empty min and raise; the wrapper raises ``ValueError`` before it picks a
    device, so the card and the CPU raise alike.  The Pallas kernel pads to
    one block and returns 3e38 (ROADMAP queue 3)."""
    empty_c = torch.zeros((0,), dtype=torch.float32)
    empty_m = torch.zeros((0,), dtype=torch.bool)
    with pytest.raises(RuntimeError):
        horizon.masked_min_plain(empty_c, empty_m)
    with pytest.raises(ValueError):
        horizon.masked_min(empty_c, empty_m)
    with pytest.raises(ValueError):
        horizon.masked_min(empty_c.to("meta"), empty_m.to("meta"))
    with pytest.raises(ValueError):
        ref.masked_min_ref(jnp.zeros((0,), jnp.float32),
                           jnp.zeros((0,), bool))
    assert float(pallas_masked_min(jnp.zeros((0,), jnp.float32),
                                   jnp.zeros((0,), bool),
                                   interpret=True)) == float(
        np.float32(3.0e38))
