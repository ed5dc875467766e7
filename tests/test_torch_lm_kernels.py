"""The port's LM kernel modules against the JAX package's, on the CPU.

On CPU tensors each wrapper runs its plain PyTorch version.  That version is
held against the Pallas kernel in interpret mode, called as
tests/test_kernels.py calls it, and against the oracles of
repro/kernels/ref.py.  The scan is held against ``ref.linear_scan_ref``
only: the Pallas ``linear_scan`` calls ``pl.load``, which jax 0.9 lacks.
Tolerances: attention f32 2e-5 and bf16 2e-2 (as tests/test_kernels.py);
the scan rtol = atol = 1e-6 in f32 (XLA may fuse the step's multiply-add,
PyTorch rounds the product first) and one bf16 rounding step (atol 1e-2 on
values of order 1) for a bf16 x.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.attention import flash_attention as pallas_flash
from repro_torch import kernels
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import ssm as kssm

# tests/test_kernels.py CASES, plus a Jamba-shaped GQA case, q_offset > 0,
# and the two corners where the Pallas kernel departs from the oracle
CASES = [
    dict(B=1, Tq=16, Tk=16, Hq=2, Hkv=2, D=8, causal=True),
    dict(B=2, Tq=33, Tk=33, Hq=4, Hkv=2, D=16, causal=True),        # GQA+pad
    dict(B=1, Tq=64, Tk=64, Hq=2, Hkv=1, D=32, causal=True,
         window=16),                                                 # local
    dict(B=1, Tq=48, Tk=48, Hq=2, Hkv=2, D=16, causal=True,
         softcap=30.0),                                              # gemma2
    dict(B=1, Tq=40, Tk=40, Hq=2, Hkv=1, D=16, causal=True,
         prefix_len=8),                                              # vlm
    dict(B=2, Tq=24, Tk=24, Hq=2, Hkv=2, D=8, causal=False),        # encoder
    dict(B=1, Tq=70, Tk=70, Hq=8, Hkv=2, D=32, causal=True),        # jamba
]
OFFSET_CASE = dict(B=2, Tq=20, Tk=50, Hq=4, Hkv=2, D=16, causal=True,
                   q_offset=30)
CORNERS = [dict(B=1, Tq=384, Tk=384, Hq=2, Hkv=2, D=16, causal=True,
                prefix_len=256),
           dict(B=1, Tq=384, Tk=384, Hq=2, Hkv=2, D=16, causal=False,
                window=64)]


def _qkv(case, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    B, Tq, Tk = case["B"], case["Tq"], case["Tk"]
    Hq, Hkv, D = case["Hq"], case["Hkv"], case["D"]
    return (rng.randn(B, Tq, Hq, D).astype(dtype),
            rng.randn(B, Tk, Hkv, D).astype(dtype),
            rng.randn(B, Tk, Hkv, D).astype(dtype))


def _kw(case):
    return {k: v for k, v in case.items()
            if k not in ("B", "Tq", "Tk", "Hq", "Hkv", "D")}


def _as(x, dtype):
    """numpy f32 -> (jax array, torch tensor) of one dtype, same values."""
    j = jnp.asarray(x).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_plain_matches_pallas_interpret(case, dtype):
    (jq, tq), (jk, tk), (jv, tv) = (_as(x, dtype) for x in _qkv(case, 0))
    want = pallas_flash(jq, jk, jv, interpret=True, block_q=16, block_k=128,
                        **_kw(case))
    got = kattn.flash_attention(tq, tk, tv, **_kw(case))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("case", CASES + [OFFSET_CASE] + CORNERS[:1])
def test_flash_plain_matches_oracle(case):
    q, k, v = _qkv(case, 1)
    want = ref.attention_ref(*map(jnp.asarray, (q, k, v)), **_kw(case))
    got = kattn.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                      **_kw(case))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("case", CORNERS, ids=["prefix_beyond_tile",
                                               "window_without_causal"])
def test_reference_corners_follow_the_oracle(case):
    """Where the Pallas kernel departs from ``attention_ref`` (ROADMAP queue
    3), the port's plain version is the oracle's formula."""
    q, k, v = _qkv(case, 2)
    jargs = tuple(map(jnp.asarray, (q, k, v)))
    want = np.asarray(ref.attention_ref(*jargs, **_kw(case)))
    pallas = np.asarray(pallas_flash(*jargs, interpret=True, block_q=128,
                                     block_k=128, **_kw(case)))
    assert np.abs(pallas - want).max() > 0.1     # the reference's deviation
    got = kattn.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                      **_kw(case))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_window_without_causal_is_refused():
    q, k, v = map(torch.from_numpy, _qkv(CORNERS[1], 3))
    with pytest.raises(ValueError, match="causal"):
        kattn.flash_attention(q, k, v, causal=False, window=64)


def test_flash_wrapper_checks_shapes():
    q = torch.zeros(1, 4, 3, 8)
    k = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="does not fit"):
        kattn.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="expected"):
        kattn.flash_attention(q, k, torch.zeros(1, 5, 2, 8))


def test_visited_tiles_skip_half_of_a_causal_sweep():
    T = 4096
    full = kattn.visited_tiles(T, T, causal=False)
    causal = kattn.visited_tiles(T, T, causal=True)
    assert full == (T // kattn.BQ) * (T // kattn.BK)
    assert 0.5 <= causal / full < 0.52
    # a tile holding prefix keys is never skipped
    pre = kattn.visited_tiles(384, 384, causal=True, prefix_len=256)
    assert pre == kattn.visited_tiles(384, 384, causal=True) + sum(
        1 for q0 in range(0, 384, kattn.BQ) for k0 in range(0, 256, kattn.BK)
        if k0 > q0 + kattn.BQ - 1)
    # windows keep only the band
    win = kattn.visited_tiles(T, T, causal=True, window=128)
    assert win < causal / 10


def _scan_inputs(B, T, D, seed, x_dtype=np.float32, with_h0=True):
    rng = np.random.RandomState(seed)
    a = rng.uniform(0.5, 1.0, (B, T, D)).astype(np.float32)
    x = rng.randn(B, T, D).astype(np.float32)
    h0 = rng.randn(B, D).astype(np.float32) if with_h0 else None
    return a, x, h0


@pytest.mark.parametrize("B,T,D,with_h0", [
    (2, 13, 40, True), (1, 1, 7, True), (3, 256, 130, False),
    (2, 300, 33, True)])
def test_linear_scan_plain_matches_ref(B, T, D, with_h0):
    a, x, h0 = _scan_inputs(B, T, D, T, with_h0=with_h0)
    want = np.asarray(ref.linear_scan_ref(
        jnp.asarray(a), jnp.asarray(x),
        None if h0 is None else jnp.asarray(h0)))
    y, h_last = kssm.linear_scan(
        torch.from_numpy(a), torch.from_numpy(x),
        None if h0 is None else torch.from_numpy(h0))
    assert y.dtype == torch.float32 and h_last.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(h_last, y[:, -1])


def test_linear_scan_plain_bf16_x():
    a, x, h0 = _scan_inputs(2, 17, 24, 4)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = ref.linear_scan_ref(jnp.asarray(a), xb, jnp.asarray(h0))
    assert want.dtype == jnp.bfloat16
    tx = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
        torch.bfloat16)
    y, h_last = kssm.linear_scan(torch.from_numpy(a), tx,
                                 torch.from_numpy(h0))
    assert y.dtype == torch.bfloat16 and h_last.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)
    # y is the f32 carry rounded once
    assert torch.equal(y[:, -1], h_last.to(torch.bfloat16))


def test_padded_steps_are_identity():
    """A chunk padded with (a=1, x=0) steps, as the reference pads, ends in
    the state of the unpadded chunk: the port's short last chunk is exact."""
    a, x, h0 = _scan_inputs(2, 9, 16, 5)
    ap = np.concatenate([a, np.ones((2, 7, 16), np.float32)], axis=1)
    xp = np.concatenate([x, np.zeros((2, 7, 16), np.float32)], axis=1)
    _, h = kssm.linear_scan_plain(*map(torch.from_numpy, (a, x, h0)))
    _, hp = kssm.linear_scan_plain(*map(torch.from_numpy, (ap, xp, h0)))
    assert torch.equal(h, hp)


def test_cpu_tensors_launch_no_kernel():
    kernels.reset_launch_counts()
    a, x, h0 = _scan_inputs(1, 4, 8, 6)
    kssm.linear_scan(*map(torch.from_numpy, (a, x, h0)))
    q, k, v = map(torch.from_numpy, _qkv(CASES[0], 7))
    kattn.flash_attention(q, k, v)
    counts = kernels.launch_counts()
    assert counts["linear_scan"] == 0 and counts["flash_attention"] == 0
    assert set(counts) == {"maxmin_solve", "fill_stats", "masked_min",
                           "flash_attention", "linear_scan"}


def test_build_lists_the_new_sources():
    from repro_torch.kernels import _build
    assert set(_build.SOURCES) == {"maxmin", "horizon", "scan", "attention",
                                   "attention_wgmma"}
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()
        flags = _build._flags(name)
        assert "arch=compute_90a,code=sm_90a" in flags
        # bit-equal kernels round each product and sum separately; the
        # attention kernels are held to a tolerance
        assert ("-fmad=false" in flags) == (not name.startswith("attention"))


def test_scan_launch_limits_at_the_boundary():
    # a serve batch of 64 at Jamba's D and chunk: B * T * D = 2**31 elements,
    # which the kernel's 64-bit offsets handle
    kssm.check_launch_limits(64, 256, 131072)
    kssm.check_launch_limits(65535, 1, 1)
    kssm.check_launch_limits(1, 2 ** 31 - 1, 2 ** 31 - 1)
    for shape in ((65536, 1, 1), (1, 2 ** 31, 1), (1, 1, 2 ** 31)):
        with pytest.raises(ValueError, match="B <= 65535"):
            kssm.check_launch_limits(*shape)


def test_flash_launch_limits_at_the_boundary():
    # 2**31 elements in q and in k: the kernel's offsets are 64-bit
    kattn.check_launch_limits(2, 2 ** 19, 2 ** 19, 16, 128)
    kattn.check_launch_limits(65535, 1, 1, 1, 256)
    kattn.check_launch_limits(1, 1, 2 ** 31 - 1, 1, 8,
                              q_offset=2 ** 31 - 2)
    for args in ((65536, 1, 1, 1, 8), (1, 1, 1, 65536, 8),
                 (1, 1, 1, 1, 257), (1, 0, 1, 1, 8), (1, 1, 0, 1, 8)):
        with pytest.raises(ValueError, match="B \\* Hq <= 65535"):
            kattn.check_launch_limits(*args)
    for kw in (dict(q_offset=2 ** 31 - 1), dict(window=2 ** 31),
               dict(prefix_len=2 ** 31)):
        with pytest.raises(ValueError, match="int32"):
            kattn.check_launch_limits(1, 1, 1, 1, 8, **kw)
