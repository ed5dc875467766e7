"""The yardstick of the wgmma flash kernel, held to the reference at the
kernel's own cases.

On the card, chip_smoke.py holds the wgmma kernel (bf16, D = 64 and 128) to
``flash_attention_plain`` within ``FLASH_TOL`` (rtol 1e-2, atol 2e-3) at the
cases of ``repro_torch.kernels.flash_cases.WGMMA_CASES``.  Here, on the CPU,
the plain version is held at exactly those cases, on the same bf16 inputs, to
the Pallas kernel in interpret mode and to ``ref.attention_ref``, within the
same tolerance.  The Pallas kernel is called with one KV block over the whole
sequence (``block_k`` = 512 >= every Tk here), so its prefix corner (ROADMAP
queue 3: it drops prefix keys beyond one KV block) does not arise.

The kernel computes the softcap's tanh as 1 - 2 / (1 + 2^(2 y log2 e)) with
the special-function unit's ex2 and rcp; the last test bounds that formula's
error in f32 against float64 tanh over the softcaps and logits the models
reach.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.attention import flash_attention as pallas_flash
from repro_torch.kernels import attention as kattn
from repro_torch.kernels.flash_cases import WGMMA_CASES

RTOL, ATOL = 1e-2, 2e-3      # chip_smoke.py's FLASH_TOL for bf16


def _inputs(case, seed):
    """bf16 q, k, v as (jax, torch) pairs holding the same values."""
    B, Tq, Tk, Hq, Hkv, D, _ = case
    rng = np.random.RandomState(seed)
    out = []
    for shape in ((B, Tq, Hq, D), (B, Tk, Hkv, D), (B, Tk, Hkv, D)):
        j = jnp.asarray(rng.randn(*shape).astype(np.float32)).astype(
            jnp.bfloat16)
        t = torch.from_numpy(np.array(j.astype(jnp.float32)))
        out.append((j, t.to(torch.bfloat16)))
    return out


@pytest.mark.parametrize("i", range(len(WGMMA_CASES)))
def test_plain_matches_pallas_and_oracle_at_the_wgmma_cases(i):
    case = WGMMA_CASES[i]
    B, Tq, Tk, Hq, Hkv, D, kw = case
    assert kattn.variant(torch.bfloat16, D).name == "wgmma"
    (jq, tq), (jk, tk), (jv, tv) = _inputs(case, i)
    got = kattn.flash_attention_plain(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    got = got.float().numpy()
    pallas = pallas_flash(jq, jk, jv, interpret=True, block_q=128,
                          block_k=512, **kw)
    oracle = ref.attention_ref(jq, jk, jv, **kw)
    for name, want in (("pallas", pallas), ("oracle", oracle)):
        assert want.dtype == jnp.bfloat16
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} case {i} {kw}")


def _kernel_softcap_logit(y, cap, eta_ex2, eta_rcp):
    """The kernel's soft-capped logit in f32, in natural units: base-2
    logit cap log2(e) - 2 cap log2(e) / (1 + 2^(2 y log2(e))) by one FMA,
    divided by log2(e); ex2 and rcp each rounded to f32 and then off by a
    relative ``eta`` (the special-function unit's error)."""
    f = np.float32
    log2e = f(np.log2(np.e))
    cap2 = f(f(cap) * log2e)
    arg = f(y) * f(f(2.0) * log2e)            # y = s * scale / cap in f32
    with np.errstate(over="ignore"):          # 2^huge = inf, as ex2 gives
        e = f(np.exp2(arg.astype(np.float64)) * (1.0 + eta_ex2))
    r = f((1.0 / (f(1.0) + e).astype(np.float64)) * (1.0 + eta_rcp))
    v2 = f(-2.0 * cap2.astype(np.float64) * r + cap2)   # one rounding: FMA
    return v2.astype(np.float64) / np.log2(np.e)


@pytest.mark.parametrize("cap", [20.0, 30.0, 50.0])
def test_softcap_tanh_formula_error(cap):
    """Over logits s * scale up to 20 caps either side (gemma2's cap 50;
    20 and 30 in chip_smoke's cases), the kernel's capped logit stays within
    1e-6 * cap (natural units; 5e-5 at cap 50) of cap * tanh(s * scale /
    cap) in float64, with the special-function unit's ex2 and rcp each off
    by up to 2^-22 relative (rcp's error alone, times the FMA's 2 cap,
    reaches 2^-21 cap).  A logit error of d moves a probability by a factor
    e^d, so 5e-5 moves an output by about 5e-5 of its size, far inside
    FLASH_TOL's rtol of 1e-2; tanh rounded to f32 and scaled is off by up to
    about 1e-7 * cap."""
    x = np.concatenate([np.linspace(-20.0, 20.0, 400001),
                        np.geomspace(1e-8, 1.0, 2001),
                        -np.geomspace(1e-8, 1.0, 2001)]) * cap
    y = (x / cap).astype(np.float32)
    want = cap * np.tanh(y.astype(np.float64))
    worst = 0.0
    for eta_ex2 in (-2.0 ** -22, 0.0, 2.0 ** -22):
        for eta_rcp in (-2.0 ** -22, 0.0, 2.0 ** -22):
            got = _kernel_softcap_logit(y, cap, eta_ex2, eta_rcp)
            assert np.isfinite(got).all()
            worst = max(worst, float(np.abs(got - want).max()))
    assert worst <= 1e-6 * cap, worst
    # saturated far out: the cap itself, to within the same bound
    far = _kernel_softcap_logit(np.float32([-1e4, 1e4]), cap, 0.0, 0.0)
    np.testing.assert_allclose(far, [-cap, cap], rtol=0, atol=1e-6 * cap)
