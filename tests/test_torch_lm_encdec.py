"""The enc-dec (seamless) and VLM (paligemma) families of the port against
the JAX package, on the CPU: the encoder, the cross-attention sub-block and
the keys and values ``prefill`` writes for it, the bidirectional patch
prefix, and the serving route of each (the harness of
``test_torch_lm_dense.py``).  Tolerances: f32 rtol = atol = 1e-4; shapes,
dtypes and greedy tokens exactly.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcm
from repro.models import lm as jlm
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm
from test_torch_lm_dense import (IMPLS, TOL, _np, assert_cache_struct_matches,
                                 assert_caches_match, assert_configs_equal,
                                 assert_forward_matches, assert_params_carried,
                                 assert_serve_matches, family, jax_forward,
                                 jbatch, make_batch, run_cached)

ARCHS = ("seamless-m4t-large-v2", "paligemma-3b")
SEAMLESS, PALIGEMMA = ARCHS


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    return family(request.param)


@pytest.fixture(scope="module")
def seamless():
    return family(SEAMLESS)


@pytest.mark.parametrize("which", ["get", "get_reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_field_by_field(arch, which):
    assert_configs_equal(arch, which)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carried_across(arch):
    assert_params_carried(arch)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_logits_match_jax(fam, impl):
    """seamless with its frames, paligemma with its patch prefix."""
    batch = make_batch(fam.jcfg, 2, 13, 11)
    assert_forward_matches(fam, impl, batch, jax_forward(fam, batch))


def test_vlm_forward_without_patches_matches_jax():
    fam = family(PALIGEMMA)
    batch = make_batch(fam.jcfg, 2, 13, 11)
    del batch["patches"]
    assert_forward_matches(fam, "pallas", batch, jax_forward(fam, batch))


@pytest.mark.parametrize("impl", IMPLS)
def test_encode_matches_jax(seamless, impl):
    frames = make_batch(seamless.jcfg, 2, 1, 5)["frames"]
    want = jax.jit(lambda p, f: jlm.encode(seamless.jcfg, p, f))(
        seamless.jparams, jnp.asarray(frames))
    got = tlm.encode(seamless.port(attn_impl=impl), seamless.tparams, frames)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_prefill_and_decode_logits_match_jax(fam):
    """The cache after prefill and four decode steps, the cross keys and
    values among them, against the reference's."""
    batch = make_batch(fam.jcfg, 2, 13, 12)
    jcache, tcache, _ = run_cached(fam, batch, 4, greedy=False)
    assert_caches_match(jcache, tcache)


def test_prefill_cross_kv_matches_jax(seamless):
    """The keys and values prefill writes into xk / xv are the encoder's
    projections, whatever enc_len the cache was made with (the reference
    replaces the leaves)."""
    batch = make_batch(seamless.jcfg, 2, 7, 13)
    S = batch["frames"].shape[1]
    for enc_len in (S, 0):
        jc = jlm.init_cache(seamless.jcfg, 2, 12, enc_len=enc_len)
        tc = tlm.init_cache(seamless.tcfg, 2, 12, enc_len=enc_len,
                            device="cpu")
        _, jc = jax.jit(lambda p, b, c: jlm.prefill(seamless.jcfg, p, b, c))(
            seamless.jparams, jbatch(batch), jc)
        _, tc = tlm.prefill(seamless.tcfg, seamless.tparams, batch, tc)
        for jl_, tl_ in zip(jc["layers"], tc["layers"]):
            for name in ("xk", "xv"):
                assert tuple(tl_[name].shape) == jl_[name].shape
                assert tl_[name].shape[2] == S
                np.testing.assert_allclose(tl_[name].numpy(),
                                           _np(jl_[name]), **TOL)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("enc_len", [0, 9])
def test_cache_struct_matches_reference(fam, compute_dtype, enc_len):
    assert_cache_struct_matches(fam, compute_dtype, enc_len=enc_len)


def test_greedy_decode_matches_jax(fam):
    """The serving route of the two families through prefill (with frames,
    or patches) and decode_step: each package's greedy tokens, equal."""
    batch = make_batch(fam.jcfg, 3, 10, 14)
    _, _, tokens = run_cached(fam, batch, 6, greedy=True)
    assert all(0 <= t < fam.jcfg.vocab for step in tokens for t in step)


def test_vlm_serve_greedy_tokens_match_jax():
    assert_serve_matches(family(PALIGEMMA))


def test_sinusoidal_positions_match():
    for n, d in ((7, 16), (33, 64)):
        want = _np(jcm.sinusoidal_positions(n, d))
        got = tcm.sinusoidal_positions(n, d, device="cpu")
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL)

