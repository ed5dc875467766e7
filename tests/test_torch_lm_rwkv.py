"""RWKV-6 (``models/rwkv.py`` and the ``ssm`` family of ``models/lm.py``)
against the JAX package, on the CPU.

Each function of the module on the same numpy inputs in both packages, then
the reduced ``rwkv6-3b`` config end to end (the harness of
``test_torch_lm_dense.py``).  Tolerances: f32 rtol = atol = 1e-4; shapes,
dtypes and greedy tokens exactly.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcm
from repro.models import rwkv as jrwkv
from repro_torch.models import common as tcm
from repro_torch.models import rwkv as trwkv
from test_torch_lm_dense import (IMPLS, TOL, _np, assert_cache_struct_matches,
                                 assert_caches_match, assert_configs_equal,
                                 assert_forward_matches, assert_params_carried,
                                 assert_serve_matches, family, jax_forward,
                                 make_batch, run_cached)

ARCH = "rwkv6-3b"
H, K = 3, 8             # heads and head size of the function-level cases


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _wkv_inputs(T, with_state, seed):
    rng = np.random.RandomState(seed)
    B = 2
    r, k, v = (rng.randn(B, T, H, K).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.3, 1.0, (B, T, H, K)).astype(np.float32)
    u = rng.randn(H, K).astype(np.float32)
    s0 = (rng.randn(B, H, K, K) if with_state
          else np.zeros((B, H, K, K))).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.fixture(scope="module")
def fam():
    return family(ARCH)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T,chunk", [(1, 4), (5, 4), (13, 4), (16, 16)])
def test_wkv_chunks(T, chunk, with_state):
    args = _wkv_inputs(T, with_state, T)
    jy, js = jrwkv._wkv_chunks(*map(jnp.asarray, args), chunk=chunk)
    ty, ts = trwkv._wkv_chunks(*map(_t, args), chunk=chunk)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), _np(js), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", [3, 8, 21])
def test_wkv_chunks_matmul(T, with_state):
    """Below and above one window of WKV_WINDOW tokens, with a ragged
    last window; decays inside the clamp, so the token loop agrees too."""
    args = _wkv_inputs(T, with_state, 100 + T)
    jy, js = jrwkv._wkv_chunks_matmul(*map(jnp.asarray, args))
    ty, ts = trwkv._wkv_chunks_matmul(*map(_t, args))
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), _np(js), **TOL)
    ly, ls = trwkv._wkv_chunks(*map(_t, args), chunk=4)
    np.testing.assert_allclose(ty.numpy(), ly.numpy(), **TOL)
    np.testing.assert_allclose(ts.numpy(), ls.numpy(), **TOL)


def test_wkv_constants_match():
    assert (trwkv.WKV_WINDOW, trwkv.WKV_LOG_CLAMP, trwkv.MAA_RANK,
            trwkv.DECAY_RANK) == (jrwkv.WKV_WINDOW, jrwkv.WKV_LOG_CLAMP,
                                  jrwkv.MAA_RANK, jrwkv.DECAY_RANK)


def _block(fam, name):
    """Layer 0's ``time`` or ``chan`` parameters, in both packages."""
    jp = {k: jnp.asarray(v[0]) for k, v in
          fam.tree["blocks"][0][name].items()}
    tp = {k: v[0] for k, v in fam.tparams["blocks"][0][name].items()}
    return jp, tp


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("impl,T", [("matmul", 11), ("matmul", 5),
                                    ("scan", 11), ("matmul", 1)])
def test_rwkv_time_mix(fam, impl, T, with_state):
    jp, tp = _block(fam, "time")
    cfg = fam.jcfg
    d, hs = cfg.d_model, cfg.rwkv_head_size
    rng = np.random.RandomState(T)
    x = rng.randn(2, T, d).astype(np.float32)
    state = None
    if with_state:
        state = (rng.randn(2, 1, d).astype(np.float32),
                 rng.randn(2, d * hs).astype(np.float32))
    jy, (jsh, js) = jrwkv.rwkv_time_mix(
        jp, jnp.asarray(x), head_size=hs, chunk=cfg.scan_chunk, impl=impl,
        state=None if state is None else tuple(map(jnp.asarray, state)))
    ty, (tsh, ts) = trwkv.rwkv_time_mix(
        tp, _t(x), head_size=hs, chunk=cfg.scan_chunk, impl=impl,
        state=None if state is None else tuple(map(_t, state)))
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    np.testing.assert_array_equal(tsh.numpy(), _np(jsh))
    np.testing.assert_allclose(ts.numpy(), _np(js), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_channel_mix(fam, with_state):
    jp, tp = _block(fam, "chan")
    rng = np.random.RandomState(7)
    x = rng.randn(2, 6, fam.jcfg.d_model).astype(np.float32)
    st = rng.randn(2, 1, fam.jcfg.d_model).astype(np.float32)
    jy, jsh = jrwkv.rwkv_channel_mix(
        jp, jnp.asarray(x), state=jnp.asarray(st) if with_state else None)
    ty, tsh = trwkv.rwkv_channel_mix(tp, _t(x),
                                     state=_t(st) if with_state else None)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    np.testing.assert_array_equal(tsh.numpy(), _np(jsh))


@pytest.mark.parametrize("groups", [1, 4])
def test_group_norm(groups):
    rng = np.random.RandomState(groups)
    x = (3 * rng.randn(2, 5, 32) + 1).astype(np.float32)
    w, b = rng.randn(32).astype(np.float32), rng.randn(32).astype(np.float32)
    want = _np(jcm.group_norm(*map(jnp.asarray, (x, w, b)), groups))
    got = tcm.group_norm(_t(x), _t(w), _t(b), groups)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_init_state(dtype):
    want = jrwkv.rwkv_init_state(3, 48, head_size=16, dtype=jnp.dtype(dtype))
    got = trwkv.rwkv_init_state(3, 48, head_size=16,
                                dtype=tcm.torch_dtype(dtype), device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and not got[k].any()
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k


# ---------------------------------------------------------------------------
# the reduced rwkv6-3b end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["get", "get_reduced"])
def test_configs_equal_field_by_field(which):
    assert_configs_equal(ARCH, which)


def test_params_carried_across():
    """The time and channel mixes' weights stay f32 in a bf16 config: the
    reference computes every projection in f32."""
    assert_params_carried(ARCH)
    assert not {"w_r", "w_k", "w_v", "w_g", "w_o"} & tcm.CAST_AT_USE


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("T", [6, 19])
def test_forward_logits_match_jax(fam, impl, T):
    """T = 6 runs the token loop, T = 19 the windowed form."""
    batch = make_batch(fam.jcfg, 2, T, 11)
    assert_forward_matches(fam, impl, batch, jax_forward(fam, batch))


def test_prefill_and_decode_logits_match_jax(fam):
    batch = make_batch(fam.jcfg, 2, 17, 12)
    jcache, tcache, _ = run_cached(fam, batch, 4, greedy=False)
    assert_caches_match(jcache, tcache)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cache_struct_matches_reference(fam, compute_dtype):
    assert_cache_struct_matches(fam, compute_dtype, enc_len=0)


def test_serve_greedy_tokens_match_jax(fam):
    assert_serve_matches(fam)
