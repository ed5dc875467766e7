"""The dense and MoE LM families of the port against the JAX package, on the
CPU: gemma2, command-r, granite-3, codeqwen1.5, granite-moe and phi3.5-moe.

Each architecture runs its reduced config.  Parameters come from the
reference's ``materialize`` (a few leaves perturbed with numpy, so that the
QKV biases, the norms' weights and biases and RWKV's token-shift mixes are
not their zero or one initial values) and reach the port through
``params_from_numpy``.  The reference runs with ``attn_impl="chunked"``
(jitted); the port runs ``pallas`` (the kernels' plain versions on CPU
tensors), ``chunked`` and ``naive``.  Tolerances, as in
``test_torch_lm.py``: f32 logits rtol = atol = 1e-4; greedy tokens, shapes
and dtypes exactly.  The harness here is shared with
``test_torch_lm_rwkv.py`` and ``test_torch_lm_encdec.py``.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import common as jcm
from repro.models import lm as jlm
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm
from repro_torch.serve.engine import Request, ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)
IMPLS = ("pallas", "chunked", "naive")
ARCHS = ("gemma2-27b", "command-r-35b", "granite-3-2b", "codeqwen1.5-7b",
         "granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b")
# leaves set away from their initial zeros / ones, by name
PERTURBED = {"bq": 0.5, "bk": 0.5, "bv": 0.5, "b": 0.2, "w": 0.2,
             "maa_x": 0.3, "maa_rkvwg": 0.3, "maa_k": 0.3, "maa_r": 0.3,
             "ln_w": 0.2, "ln_b": 0.2}
PATCHES, FRAMES = 6, 9          # prefix and source lengths of the batches


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@dataclasses.dataclass
class Family:
    """One architecture, reduced, in both packages."""
    arch: str
    jcfg: object
    jparams: dict
    tcfg: object
    tree: dict                  # the parameters as numpy arrays
    tparams: dict

    def port(self, **overrides):
        return dataclasses.replace(self.tcfg, **overrides)


def _perturb(tree, rng, path=()):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturb(v, rng, path) for v in tree]
    a = np.asarray(tree, np.float32)
    if path[-1] in PERTURBED:
        a = a + PERTURBED[path[-1]] * rng.randn(*a.shape).astype(np.float32)
    return a


def family(arch: str, seed: int = 3) -> Family:
    jcfg = jconfigs.get_reduced(arch, attn_impl="chunked")
    raw = jcm.materialize(jlm.lm_spec(jcfg), jax.random.PRNGKey(seed))
    tree = _perturb(jax.tree.map(np.asarray, raw), np.random.RandomState(seed))
    return Family(arch, jcfg, jax.tree.map(jnp.asarray, tree),
                  tconfigs.get_reduced(arch, attn_impl="pallas"), tree,
                  tcm.params_from_numpy(tree, device="cpu"))


def make_batch(cfg, B: int, T: int, seed: int) -> dict:
    """Tokens, and the patches or frames the family reads, from numpy."""
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, cfg.vocab, (B, T))}
    if cfg.family == "vlm":
        batch["patches"] = rng.randn(B, PATCHES, cfg.d_model).astype(
            np.float32)
    if cfg.is_encdec:
        batch["frames"] = rng.randn(B, FRAMES, cfg.d_model).astype(np.float32)
    return batch


def jbatch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def jax_fns(jcfg):
    """The reference's forward, prefill and decode_step, jitted."""
    return (jax.jit(functools.partial(jlm.forward, jcfg)),
            jax.jit(functools.partial(jlm.prefill, jcfg)),
            jax.jit(functools.partial(jlm.decode_step, jcfg)))


def assert_configs_equal(arch: str, which: str) -> None:
    jcfg = getattr(jconfigs, which)(arch)
    tcfg = getattr(tconfigs, which)(arch)
    jf = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    tf = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    assert jf.keys() == tf.keys()
    for k in jf:
        want = jf[k]
        if k == "compute_dtype":
            want = str(jnp.dtype(want))
        assert tf[k] == want, (arch, k)
    assert tcfg.cdtype == {"float32": torch.float32,
                           "bfloat16": torch.bfloat16}[str(jcfg.cdtype)]
    assert tcfg.is_encdec == jcfg.is_encdec
    jk = jlm.find_pattern(jlm.layer_kinds(jcfg))
    tk = tlm.find_pattern(tlm.layer_kinds(tcfg))
    assert [dataclasses.asdict(x) for x in jk[0]] == [
        dataclasses.asdict(x) for x in tk[0]] and jk[1] == tk[1]
    assert (tcm.count_params(tlm.lm_spec(tcfg))
            == jcm.count_params(jlm.lm_spec(jcfg)))


def assert_forward_matches(fam: Family, impl: str, batch: dict, want):
    got, aux = tlm.forward(fam.port(attn_impl=impl), fam.tparams, batch)
    assert got.dtype == torch.float32 and got.shape == want[0].shape
    np.testing.assert_allclose(got.numpy(), want[0], **TOL)
    np.testing.assert_allclose(aux.numpy(), want[1], **TOL)


def jax_forward(fam: Family, batch: dict):
    logits, aux = jax_fns(fam.jcfg)[0](fam.jparams, jbatch(batch))
    return _np(logits), _np(aux)


def widened(fam: Family) -> tuple:
    """(JAX cfg, port cfg) with the MoE capacity widened so that no slot
    drops, as ``test_arch_smoke.py`` widens it for prefill and decode."""
    if not fam.jcfg.n_experts:
        return fam.jcfg, fam.tcfg
    cf = float(fam.jcfg.n_experts)
    return (dataclasses.replace(fam.jcfg, capacity_factor=cf),
            fam.port(capacity_factor=cf))


def run_cached(fam: Family, batch: dict, steps: int, *, greedy: bool):
    """Prefill on all but the last ``steps`` tokens, then ``steps`` decode
    steps, in both packages; each step's logits compared.  ``greedy``
    feeds each package's own argmax back instead of the batch's tokens.
    Returns (JAX cache, port cache, tokens of each step)."""
    jcfg, tcfg = widened(fam)
    _, jpre, jdec = jax_fns(jcfg)
    toks = batch["tokens"]
    B, T = toks.shape
    n_pre = T - steps
    P = batch["patches"].shape[1] if "patches" in batch else 0
    enc_len = batch["frames"].shape[1] if "frames" in batch else 0
    max_len = P + T + 2
    pre = dict(batch, tokens=toks[:, :n_pre])
    jcache = jlm.init_cache(jcfg, B, max_len, enc_len=enc_len)
    tcache = tlm.init_cache(tcfg, B, max_len, enc_len=enc_len, device="cpu")
    jl, jcache = jpre(fam.jparams, jbatch(pre), jcache)
    tl, tcache = tlm.prefill(tcfg, fam.tparams, pre, tcache)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    out = []
    for s in range(steps):
        if greedy:
            jt = np.asarray(jnp.argmax(jl, axis=-1))[:, None]
            tt = torch.argmax(tl, dim=-1)[:, None].numpy()
            assert (jt == tt).all(), (fam.arch, s, jt, tt)
        else:
            jt = tt = toks[:, n_pre + s:n_pre + s + 1]
        out.append(tt[:, 0].tolist())
        jl, jcache = jdec(fam.jparams, jnp.asarray(jt), jcache)
        tl, tcache = tlm.decode_step(tcfg, fam.tparams, tt, tcache)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL,
                                   err_msg=f"{fam.arch} decode step {s}")
    assert tcache["index"] == int(jcache["index"]) == P + n_pre + steps
    return jcache, tcache, out


def assert_caches_match(jcache, tcache) -> None:
    for jl_, tl_ in zip(jcache["layers"], tcache["layers"]):
        for path, t in tcm.leaves(tl_):
            j = jl_
            for k in path:
                j = j[k]
            assert tuple(t.shape) == j.shape, path
            np.testing.assert_allclose(t.float().numpy(), _np(j), **TOL,
                                       err_msg=str(path))


def assert_cache_struct_matches(fam: Family, compute_dtype: str, *,
                                enc_len: int) -> None:
    """Shapes and dtypes of every cache leaf against the reference's
    ``cache_struct`` (enc-dec: ``xk`` / ``xv`` of ``enc_len``)."""
    js = jlm.cache_struct(dataclasses.replace(
        fam.jcfg, compute_dtype=compute_dtype), 3, 24, enc_len=enc_len)
    ts = tlm.cache_struct(fam.port(compute_dtype=compute_dtype), 3, 24,
                          enc_len=enc_len)
    assert ts["index"] == 0 and len(ts["layers"]) == len(js["layers"])
    for jl_, tl_ in zip(js["layers"], ts["layers"]):
        want = [(p, s.shape, str(s.dtype)) for p, s in tcm.leaves(jl_)]
        got = [(p, tuple(t.shape), str(t.dtype).split(".")[-1])
               for p, t in tcm.leaves(tl_)]
        assert got == want
        assert all(t.device.type == "meta" for _, t in tcm.leaves(tl_))


def serve(engine_cls, request_cls, cfg, params, **kw):
    eng = engine_cls(cfg, params, batch_size=4, max_len=32, eos_id=-1, **kw)
    rng = np.random.RandomState(4)
    for rid, plen in enumerate((3, 9, 5, 12)):
        eng.submit(request_cls(rid=rid, prompt=[int(t) for t in rng.randint(
            2, cfg.vocab, plen)], max_new_tokens=6))
    stats = eng.run()
    return [r.output for r in sorted(eng.done, key=lambda r: r.rid)], stats


def assert_serve_matches(fam: Family) -> None:
    want, _ = serve(JServeEngine, JRequest, fam.jcfg, fam.jparams)
    got, stats = serve(ServeEngine, Request, fam.tcfg, fam.tparams,
                       device="cpu")
    assert got == want, fam.arch
    assert stats["requests"] == 4 and stats["tokens"] == 24


def assert_params_carried(arch: str) -> None:
    """Leaf paths, shapes and storage dtypes of the port's trees against the
    reference's ``materialize(lm_spec(cfg))`` (reduced config)."""
    jcfg = jconfigs.get_reduced(arch)
    ref = jcm.materialize(jlm.lm_spec(jcfg), jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, ref)
    want = [(p, a.shape) for p, a in tcm.leaves(tree)]
    spec = tlm.lm_spec(tconfigs.get_reduced(arch))
    assert [(p, s.shape) for p, s in tcm.leaves(spec)] == want
    for compute in ("float32", "bfloat16"):
        got = tcm.params_from_numpy(tree, device="cpu", compute_dtype=compute)
        made = tlm.init_params(tconfigs.get_reduced(
            arch, compute_dtype=compute), 0, device="cpu")
        for params in (got, made):
            assert [(p, tuple(t.shape)) for p, t in tcm.leaves(params)] == want
            for p, t in tcm.leaves(params):
                assert t.dtype == tcm.storage_dtype(p, compute), p
        for (p, t), (_, a) in zip(tcm.leaves(got), tcm.leaves(tree)):
            if t.dtype == torch.float32:
                np.testing.assert_array_equal(t.numpy(), a, err_msg=str(p))


# ---------------------------------------------------------------------------
# the six dense and MoE architectures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    return family(request.param)


@pytest.fixture(scope="module")
def fwd(fam):
    batch = make_batch(fam.jcfg, 2, 19, 11)
    return batch, jax_forward(fam, batch)


@pytest.mark.parametrize("which", ["get", "get_reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_field_by_field(arch, which):
    assert_configs_equal(arch, which)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carried_across(arch):
    assert_params_carried(arch)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_logits_match_jax(fam, fwd, impl):
    assert_forward_matches(fam, impl, *fwd)


def test_prefill_and_decode_logits_match_jax(fam):
    batch = make_batch(fam.jcfg, 2, 17, 12)
    jcache, tcache, _ = run_cached(fam, batch, 4, greedy=False)
    assert_caches_match(jcache, tcache)


def test_serve_greedy_tokens_match_jax(fam):
    assert_serve_matches(fam)
