"""The port's LM stack against the JAX package, on the CPU.

Inputs and parameters are made with numpy or the reference's own
``materialize`` and handed to both packages as numpy arrays.  The JAX side
runs the reduced Jamba config with ``attn_impl="chunked"`` (its Pallas Mamba
path needs ``pl.load``, which jax 0.9 lacks); the port runs it with
``attn_impl="pallas"``, which on CPU tensors takes the kernels' plain
versions, and with ``"chunked"``.  Tolerances: f32 logits and activations
rtol = atol = 1e-4 (summation order differs between XLA and PyTorch);
integer results (routing keep mask, greedy tokens) exactly; bf16 logits
atol 0.1 (bf16 rounds at other places in the two frameworks, module by
module: about 3 significant digits per op over 8 layers).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import common as jcm
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import ssm as kssm
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "jamba-v0.1-52b"
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ATOL = 0.1


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


@pytest.fixture(scope="module")
def jamba():
    """(JAX cfg, JAX params, port cfg, port params), reduced, f32."""
    jcfg = jconfigs.get_reduced(ARCH, attn_impl="chunked")
    jparams = jcm.materialize(jlm.lm_spec(jcfg), jax.random.PRNGKey(3))
    tcfg = tconfigs.get_reduced(ARCH, attn_impl="pallas")
    tparams = tcm.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(B, T, vocab, seed):
    return np.random.RandomState(seed).randint(0, vocab, (B, T))


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["get", "get_reduced"])
def test_jamba_configs_equal_field_by_field(which):
    jcfg = getattr(jconfigs, which)(ARCH)
    tcfg = getattr(tconfigs, which)(ARCH)
    jf = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    tf = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    assert jf.keys() == tf.keys()
    for k in jf:
        want = jf[k]
        if k == "compute_dtype":
            want = str(jnp.dtype(want))
        assert tf[k] == want, k
    assert tcfg.d_inner == jcfg.d_inner
    assert tcfg.cdtype == {"float32": torch.float32,
                           "bfloat16": torch.bfloat16}[str(jcfg.cdtype)]


def test_unported_archs_raise():
    """Every architecture of the reference resolves in the port (and its
    spec builds), an unknown one raises KeyError, and neither package's
    ServeEngine serves an enc-dec config: its requests carry no frames.
    The reference fails on its first prefill; the port refuses when the
    engine is made and names the route that serves it."""
    assert list(tconfigs.ARCHS) == list(jconfigs.ARCHS)
    for arch in jconfigs.ARCHS:
        for which in ("get", "get_reduced"):
            cfg = getattr(tconfigs, which)(arch)
            assert cfg.name == arch
            tlm.lm_spec(cfg)
    with pytest.raises(KeyError):
        tconfigs.get("no-such-model")
    with pytest.raises(KeyError):
        tconfigs.get_reduced("no-such-model")
    encdec = "seamless-m4t-large-v2"
    jcfg = jconfigs.get_reduced(encdec)
    jparams = jcm.materialize(jlm.lm_spec(jcfg), jax.random.PRNGKey(0))
    jeng = JServeEngine(jcfg, jparams, batch_size=1, max_len=16)
    jeng.submit(JRequest(rid=0, prompt=[3, 4, 5], max_new_tokens=2))
    with pytest.raises(KeyError, match="frames"):
        jeng.run()
    tcfg = tconfigs.get_reduced(encdec)
    tparams = tlm.init_params(tcfg, 0, device="cpu")
    with pytest.raises(ValueError, match="lm.prefill.*lm.decode_step"):
        ServeEngine(tcfg, tparams, device="cpu")


def test_layer_pattern_and_spec_match():
    for n in (8, 16, 32):
        jcfg = jconfigs.get(ARCH, n_layers=n)
        tcfg = tconfigs.get(ARCH, n_layers=n)
        jk = jlm.find_pattern(jlm.layer_kinds(jcfg))
        tk = tlm.find_pattern(tlm.layer_kinds(tcfg))
        assert [dataclasses.asdict(x) for x in jk[0]] == [
            dataclasses.asdict(x) for x in tk[0]] and jk[1] == tk[1]
        assert (tcm.count_params(tlm.lm_spec(tcfg))
                == jcm.count_params(jlm.lm_spec(jcfg)))
    jpaths = [p for p, _ in jcm._tree_paths(jlm.lm_spec(jcfg))]
    tpaths = [p for p, _ in tcm.leaves(tlm.lm_spec(tcfg))]
    assert jpaths == tpaths


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_params_from_numpy_round_trip_and_storage(jamba, compute_dtype):
    _, jparams, _, _ = jamba
    tree = jax.tree.map(np.asarray, jparams)
    got = tcm.params_from_numpy(tree, device="cpu",
                                compute_dtype=compute_dtype)
    back = tcm.to_numpy(got)
    cast = compute_dtype == "bfloat16"
    for path, leaf in tcm.leaves(got):
        want = tree
        for k in path:
            want = want[int(k)] if isinstance(want, list) else want[k]
        name = path[-1]
        assert leaf.dtype == (torch.bfloat16 if cast and name in
                              tcm.CAST_AT_USE else torch.float32), path
        b = back
        for k in path:
            b = b[int(k)] if isinstance(b, list) else b[k]
        if leaf.dtype == torch.float32:
            np.testing.assert_array_equal(b, want)
        else:   # once-rounded, as the reference's cast at use rounds
            np.testing.assert_array_equal(
                b, _np(jnp.asarray(want).astype(jnp.bfloat16)))


def test_materialize_storage_and_init():
    cfg = tconfigs.get_reduced(ARCH, compute_dtype="bfloat16")
    spec = tlm.lm_spec(cfg)
    a = tcm.materialize(spec, torch.Generator().manual_seed(0), device="cpu",
                        compute_dtype=cfg.compute_dtype)
    b = tlm.init_params(cfg, 0, device="cpu")
    for (path, x), (_, y), (_, ps) in zip(tcm.leaves(a), tcm.leaves(b),
                                          tcm.leaves(spec)):
        assert tuple(x.shape) == ps.shape and torch.equal(x, y), path
        assert x.dtype == tcm.storage_dtype(path, "bfloat16"), path
        if ps.init == "const":
            assert torch.all(x == ps.scale)
        if ps.init == "fan_in":
            fan = ps.fan_in or int(np.prod(ps.shape[:-1]))
            assert abs(x.float().std().item() * fan ** 0.5 - 1) < 0.2, path


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_rms_norm():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 64).astype(np.float32)
    w = rng.randn(64).astype(np.float32)
    for offset in (0.0, 1.0):
        want = _np(jcm.rms_norm(jnp.asarray(x), jnp.asarray(w),
                                offset=offset))
        got = tcm.rms_norm(_t(x), _t(w), offset=offset).numpy()
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 12).astype(np.float32)
    w = rng.randn(4, 12).astype(np.float32)
    b = rng.randn(12).astype(np.float32)
    st = rng.randn(2, 3, 12).astype(np.float32) if with_state else None
    jy, js = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               state=None if st is None else jnp.asarray(st))
    ty, ts = tssm._causal_conv(_t(x), _t(w), _t(b),
                               state=None if st is None else _t(st))
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    np.testing.assert_array_equal(ts.numpy(), _np(js))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", [1, 23])
def test_mamba_apply(jamba, with_state, T):
    jcfg, jparams, _, tparams = jamba
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["mamba"])
    tp = tcm.tree_map(lambda _, a: a[0], tparams["blocks"][0]["mamba"])
    rng = np.random.RandomState(T)
    x = rng.randn(2, T, jcfg.d_model).astype(np.float32)
    state = None
    if with_state:
        state = (rng.randn(2, 3, jcfg.d_inner).astype(np.float32),
                 rng.randn(2, jcfg.d_inner * 16).astype(np.float32))
    jy, (jc, jh) = jssm.mamba_apply(
        jp, jnp.asarray(x), chunk=jcfg.scan_chunk, impl="chunked",
        state=None if state is None else tuple(map(jnp.asarray, state)))
    for impl in ("pallas", "chunked"):
        ty, (tc, th) = tssm.mamba_apply(
            tp, _t(x), chunk=jcfg.scan_chunk, impl=impl,
            state=None if state is None else tuple(map(_t, state)))
        np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
        np.testing.assert_allclose(tc.numpy(), _np(jc), **TOL)
        np.testing.assert_allclose(th.numpy(), _np(jh), **TOL)


@pytest.mark.parametrize("T,chunk", [(23, 8), (16, 16), (5, 16)])
def test_scan_chunks(T, chunk):
    rng = np.random.RandomState(T)
    a = rng.uniform(0.5, 1.0, (2, T, 12)).astype(np.float32)
    u = rng.randn(2, T, 12).astype(np.float32)
    h0 = rng.randn(2, 12).astype(np.float32)
    jh, jl = jssm._scan_chunks(*map(jnp.asarray, (a, u, h0)), chunk=chunk,
                               impl="chunked")
    for impl in ("pallas", "chunked"):
        th, tl = tssm._scan_chunks(*map(_t, (a, u, h0)), chunk=chunk,
                                   impl=impl)
        np.testing.assert_allclose(th.numpy(), _np(jh), **TOL)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)


def test_mamba_init_state_matches_reference():
    jc, js = jssm.mamba_init_state(3, 32, d_state=8, d_conv=4)
    tc, ts = tssm.mamba_init_state(3, 32, d_state=8, d_conv=4, device="cpu")
    for j, t in ((jc, tc), (js, ts)):
        assert tuple(t.shape) == j.shape and not t.any()
        assert str(t.dtype).split(".")[-1] == str(j.dtype)


def _jax_keep(p, x, top_k, capacity_factor):
    """The reference's keep mask, by the lines of repro/models/moe.py."""
    B, T, d = x.shape
    E = p["router"].shape[1]
    N, k = B * T, top_k
    C = max(int(-(-N * k // E) * capacity_factor), 1)
    logits = x.reshape(N, d).astype(jnp.float32) @ p["router"]
    _, sel = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    onehot = jax.nn.one_hot(sel.swapaxes(0, 1).reshape(-1), E,
                            dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    pos = pos.reshape(k, N).swapaxes(0, 1).reshape(-1)
    return np.asarray(pos < C), C


@pytest.mark.parametrize("capacity_factor", [1.25, 4.0])
def test_moe_apply(jamba, capacity_factor):
    jcfg, jparams, _, tparams = jamba
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][1]["ffn"])
    tp = tcm.tree_map(lambda _, a: a[0], tparams["blocks"][1]["ffn"])
    rng = np.random.RandomState(5)
    # a shared component along expert 0's router column skews the routing:
    # the default capacity then drops slots
    r0 = np.asarray(jp["router"])[:, 0]
    x = (rng.randn(3, 21, jcfg.d_model) + 3 * r0 / np.linalg.norm(r0) * 8
         ).astype(np.float32)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), top_k=2,
                              capacity_factor=capacity_factor)
    ty, taux = tmoe.moe_apply(tp, _t(x), top_k=2,
                              capacity_factor=capacity_factor)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    want_keep, C = _jax_keep(jp, jnp.asarray(x), 2, capacity_factor)
    assert C == tmoe.capacity(63, 2, 4, capacity_factor)
    probs = torch.softmax(_t(x).reshape(63, -1) @ tp["router"], dim=-1)
    _, _, _, keep = tmoe.route(probs, 2, C)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if capacity_factor == 1.25:
        assert not want_keep.all()     # the default drops some slots
    assert float(taux["moe_dropped_frac"]) == float(
        jaux["moe_dropped_frac"])
    for k in ("moe_load_balance", "moe_z_loss"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), **TOL)


def test_route_ties_go_to_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    gate, sel, _, _ = tmoe.route(probs, 2, 4)
    _, jsel = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    np.testing.assert_allclose(gate.numpy(), 0.5)


@pytest.mark.parametrize("kv_len", [None, 1, 20, 45])
def test_chunked_attention_host_kv_len(kv_len):
    rng = np.random.RandomState(7)
    B, Tk, Hq, Hkv, D = 2, 48, 4, 2, 16
    Tq = 1 if kv_len else 40
    q = rng.randn(B, Tq, Hq, D).astype(np.float32)
    k = rng.randn(B, Tk, Hkv, D).astype(np.float32)
    v = rng.randn(B, Tk, Hkv, D).astype(np.float32)
    off = (kv_len - 1) if kv_len else 0
    kw = dict(causal=True, q_offset=off, q_chunk=16, k_chunk=16)
    want = jattn.chunked_attention(
        *map(jnp.asarray, (q, k, v)),
        kv_len=None if kv_len is None else jnp.asarray(kv_len), **kw)
    got = tattn.chunked_attention(*map(_t, (q, k, v)), kv_len=kv_len, **kw)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    naive = tattn.naive_attention(*map(_t, (q, k, v)), kv_len=kv_len,
                                  causal=True, q_offset=off)
    np.testing.assert_allclose(got.numpy(), naive.numpy(), **TOL)


@pytest.mark.parametrize("index", [0, 5, 13, 14, 20, -3, -20])
def test_cache_update_matches_dynamic_update_slice(index):
    rng = np.random.RandomState(index % 7)
    ck = rng.randn(2, 16, 2, 4).astype(np.float32)
    cv = rng.randn(2, 16, 2, 4).astype(np.float32)
    kn = rng.randn(2, 3, 2, 4).astype(np.float32)
    vn = rng.randn(2, 3, 2, 4).astype(np.float32)
    jk, jv = jattn.cache_update(*map(jnp.asarray, (ck, cv, kn, vn)),
                                jnp.asarray(index))
    tk, tv = tattn.cache_update(*map(_t, (ck, cv, kn, vn)), index)
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    np.testing.assert_array_equal(tv.numpy(), _np(jv))


def test_attention_gate_sends_the_cache_path_to_chunked():
    rng = np.random.RandomState(2)
    q, k, v = (_t(rng.randn(1, 4, 2, 8)) for _ in range(3))
    calls = []
    orig = kattn.flash_attention_plain
    kattn.flash_attention_plain = lambda *a, **kw: calls.append(1) or orig(
        *a, **kw)
    try:
        tattn.attention(q, k, v, impl="pallas", kv_len=4)
        assert not calls
        tattn.attention(q, k, v, impl="pallas")
        assert calls
    finally:
        kattn.flash_attention_plain = orig


# ---------------------------------------------------------------------------
# the slice: forward, prefill + decode, serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_forward(jamba):
    jcfg, jparams, _, _ = jamba
    toks = _tokens(2, 37, jcfg.vocab, 11)
    logits, aux = jlm.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    return toks, _np(logits), _np(aux)


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_forward_logits_match_jax(jamba, jax_forward, impl):
    _, _, tcfg, tparams = jamba
    toks, want, want_aux = jax_forward
    counts = (kattn.flash_attention.launches, kssm.linear_scan.launches)
    logits, aux = tlm.forward(dataclasses.replace(tcfg, attn_impl=impl),
                              tparams, {"tokens": toks})
    assert logits.dtype == torch.float32 and logits.shape == want.shape
    np.testing.assert_allclose(logits.numpy(), want, **TOL)
    np.testing.assert_allclose(aux.numpy(), want_aux, **TOL)
    # CPU tensors take the plain versions: no kernel launched
    assert counts == (kattn.flash_attention.launches,
                      kssm.linear_scan.launches)


def test_prefill_and_decode_logits_match_jax(jamba):
    jcfg, jparams, tcfg, tparams = jamba
    B, P, steps, max_len = 2, 21, 5, 40
    toks = _tokens(B, P + steps, jcfg.vocab, 12)
    jcache = jlm.init_cache(jcfg, B, max_len)
    tcache = tlm.init_cache(tcfg, B, max_len, device="cpu")
    jl, jcache = jlm.prefill(jcfg, jparams,
                             {"tokens": jnp.asarray(toks[:, :P])}, jcache)
    tl, tcache = tlm.prefill(tcfg, tparams, {"tokens": toks[:, :P]}, tcache)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    for s in range(steps):
        step = toks[:, P + s:P + s + 1]
        jl, jcache = jlm.decode_step(jcfg, jparams, jnp.asarray(step), jcache)
        tl, tcache = tlm.decode_step(tcfg, tparams, step, tcache)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    assert tcache["index"] == int(jcache["index"]) == P + steps
    for jl_, tl_ in zip(jcache["layers"], tcache["layers"]):
        for path, t in tcm.leaves(tl_):
            j = jl_
            for k in path:
                j = j[k]
            np.testing.assert_allclose(t.numpy(), _np(j), **TOL)


def test_cache_struct_matches_reference(jamba):
    jcfg, _, tcfg, _ = jamba
    js = jlm.cache_struct(jcfg, 3, 24)
    ts = tlm.cache_struct(tcfg, 3, 24)
    assert ts["index"] == 0
    for jl_, tl_ in zip(js["layers"], ts["layers"]):
        for path, t in tcm.leaves(tl_):
            j = jl_
            for k in path:
                j = j[k]
            assert tuple(t.shape) == j.shape and t.device.type == "meta"


def _serve(engine_cls, request_cls, cfg, params, **kw):
    eng = engine_cls(cfg, params, batch_size=4, max_len=32, eos_id=-1, **kw)
    rng = np.random.RandomState(4)
    for rid, plen in enumerate((3, 9, 5, 12)):
        eng.submit(request_cls(rid=rid, prompt=[int(t) for t in rng.randint(
            2, cfg.vocab, plen)], max_new_tokens=6))
    stats = eng.run()
    return [r.output for r in sorted(eng.done, key=lambda r: r.rid)], stats


def test_serve_greedy_tokens_match_jax(jamba):
    jcfg, jparams, tcfg, tparams = jamba
    want, _ = _serve(JServeEngine, JRequest, jcfg, jparams)
    got, stats = _serve(ServeEngine, Request, tcfg, tparams, device="cpu")
    assert got == want
    assert stats["requests"] == 4 and stats["tokens"] == 24
    assert all(len(o) == 6 for o in got)


def test_serve_sampling_is_seeded(jamba):
    _, _, tcfg, tparams = jamba
    a, _ = _serve(ServeEngine, Request, tcfg, tparams, device="cpu",
                  temperature=1.0, seed=3)
    b, _ = _serve(ServeEngine, Request, tcfg, tparams, device="cpu",
                  temperature=1.0, seed=3)
    assert a == b and all(0 <= t < tcfg.vocab for o in a for t in o)


def test_entry_points_set_xla_product_precision(jamba, monkeypatch):
    """forward, prefill and decode (hence ServeEngine) set XLA's product
    precision for the parameters' device; on a CUDA device that turns TF32
    and reduced-precision bf16 reductions off, and on the CPU changes
    nothing."""
    from repro_torch import device as tdevice

    _, _, tcfg, tparams = jamba
    seen = []
    monkeypatch.setattr(tlm, "match_xla_matmul_on", seen.append)
    toks = _tokens(2, 5, tcfg.vocab, 4)
    tlm.forward(tcfg, tparams, {"tokens": toks})
    cache = tlm.init_cache(tcfg, 2, 8, device="cpu")
    _, cache = tlm.prefill(tcfg, tparams, {"tokens": toks}, cache)
    tlm.decode_step(tcfg, tparams, toks[:, :1], cache)
    assert seen == [torch.device("cpu")] * 3

    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    names = [(mm, "allow_tf32"), (cudnn, "allow_tf32"),
             (mm, "allow_bf16_reduced_precision_reduction")]
    for obj, name in names:
        monkeypatch.setattr(obj, name, True)
    tdevice.match_xla_matmul_on("cpu")
    assert all(getattr(obj, name) for obj, name in names)
    tdevice.match_xla_matmul_on(torch.device("cuda"))
    assert not any(getattr(obj, name) for obj, name in names)


def test_bf16_forward_logits_match_jax(jamba):
    jcfg, jparams, tcfg, _ = jamba
    jcfg = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, compute_dtype="bfloat16")
    toks = _tokens(1, 24, jcfg.vocab, 13)
    want, _ = jlm.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    tree = jax.tree.map(np.asarray, jparams)
    outs = []
    for storage in ("float32", "bfloat16"):
        params = tcm.params_from_numpy(tree, device="cpu",
                                       compute_dtype=storage)
        outs.append(tlm.forward(tcfg, params, {"tokens": toks})[0])
    # storing in bf16 computes the same numbers as casting at each use
    assert torch.equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[1].numpy(), _np(want), rtol=0,
                               atol=BF16_ATOL)


DENSE_CASES = {
    # gemma2-like: rope, local/global windows, both softcaps, sandwich norms,
    # (1 + w) norms, embedding scale, tied embeddings, gelu
    "local_global": dict(
        family="dense", n_layers=4, d_model=32, n_heads=4, n_kv_heads=2,
        d_head=8, d_ff=64, vocab=128, window=8, local_global_period=2,
        attn_softcap=50.0, final_softcap=30.0, sandwich_norm=True,
        norm_offset=1.0, embed_scale=5.0, act="gelu", q_chunk=8, k_chunk=8,
        compute_dtype="float32"),
    # command-r / granite-like: parallel block, qkv bias, layer norm, logit
    # and residual multipliers, untied embeddings, sinusoidal positions
    "parallel": dict(
        family="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
        d_head=8, d_ff=64, vocab=128, parallel_block=True, qkv_bias=True,
        norm="layer", norm_eps=1e-5, logit_scale=0.5, embed_multiplier=2.0,
        residual_multiplier=0.7, tie_embeddings=False, use_rope=False,
        pos_embed="sinusoidal", q_chunk=8, k_chunk=8,
        compute_dtype="float32"),
}


@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_dense_attention_stack_matches_jax(name):
    """The attention-layer branches of apply_layer that Jamba leaves out,
    on ModelConfigs built field for field in both packages."""
    fields = DENSE_CASES[name]
    jcfg = jlm.ModelConfig(**fields)
    jparams = jcm.materialize(jlm.lm_spec(jcfg), jax.random.PRNGKey(7))
    tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.RandomState(8)
    for leaf in ("bq", "bk", "bv"):     # non-zero biases
        for blk in tree["blocks"]:
            if leaf in blk["attn"]:
                blk["attn"][leaf] = rng.randn(*blk["attn"][leaf].shape
                                              ).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    toks = _tokens(2, 19, jcfg.vocab, 9)
    want, _ = jlm.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    tparams = tcm.params_from_numpy(tree, device="cpu")
    for impl in ("pallas", "chunked", "naive"):
        tcfg = tlm.ModelConfig(**fields, attn_impl=impl)
        got, _ = tlm.forward(tcfg, tparams, {"tokens": toks})
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
