"""The port's optimiser against the JAX package's, on the CPU: AdamW on
identical numpy gradients, parameters and moments within 1e-6; the
learning-rate schedules at warmup, peak and end; int8 quantisation (equal
int8 values, scales within 1e-7) and the error-feedback pass; and the
reference's own checks of ``tests/test_train_ckpt.py`` (the quantisation
bound and AdamW's first-step direction) on the port."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.optim import schedule as jschedule
from repro_torch.models import common as tcm
from repro_torch.optim import adamw, compress, schedule

TOL6 = dict(rtol=1e-6, atol=1e-6)


def _tree(seed: int, scale: float = 1.0) -> dict:
    """A parameter-shaped tree of numpy arrays: dicts, a list, odd shapes."""
    rng = np.random.RandomState(seed)
    f = lambda *s: (scale * rng.randn(*s)).astype(np.float32)
    return {"embed": f(11, 6), "final_norm": {"w": f(6)},
            "blocks": [{"attn": {"wq": f(6, 2, 3), "wo": f(2, 3, 6)},
                        "ln": {"w": f(6)}},
                       {"ffn": {"w_gu": f(6, 8), "w_down": f(4, 6)}}]}


def _t(tree):
    return tcm.tree_map(lambda _, a: torch.from_numpy(a.copy()), tree)


def _j(tree):
    return tcm.tree_map(lambda _, a: jnp.asarray(a), tree)


def _close(got, want, **tol):
    for path, t in tcm.leaves(got):
        w = want
        for k in path:
            w = w[k] if isinstance(w, dict) else w[int(k)]
        np.testing.assert_allclose(t.numpy(), np.asarray(w), **tol,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("max_grad_norm", [1.0, 1e3])
@pytest.mark.parametrize("step0", [0, 5])
def test_adamw_update_matches_reference(max_grad_norm, step0):
    """One update from the same params, grads and moments (clipped and
    unclipped; first and a later step), then a second update on new
    grads, in both packages."""
    p, m, v = _tree(1), _tree(2, 0.1), _tree(3, 0.01)
    v = tcm.tree_map(lambda _, a: np.abs(a), v)
    jstate = jadamw.AdamWState(jnp.int32(step0), _j(m), _j(v))
    tstate = adamw.AdamWState(torch.tensor(step0, dtype=torch.int32),
                              _t(m), _t(v))
    jp, tp = _j(p), _t(p)
    for seed, lr in ((4, 1e-2), (5, 3e-3)):
        g = _tree(seed, 0.5)
        jlr = jnp.float32(lr)
        jp, jstate, jmet = jadamw.update(
            _j(g), jstate, jp, lr=jlr, weight_decay=0.1,
            max_grad_norm=max_grad_norm)
        tp, tstate, tmet = adamw.update(
            _t(g), tstate, tp, lr=torch.tensor(lr), weight_decay=0.1,
            max_grad_norm=max_grad_norm)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), **TOL6)
        assert int(tstate.step) == int(jstate.step)
        assert tstate.step.dtype == torch.int32
        _close(tp, jp, **TOL6)
        _close(tstate.m, jstate.m, **TOL6)
        _close(tstate.v, jstate.v, **TOL6)


def test_adamw_update_writes_in_place():
    p, g = _t(_tree(1)), _t(_tree(2))
    st = adamw.init(p)
    before = tcm.tree_map(lambda _, t: t.clone(), p)
    p2, st2, _ = adamw.update(g, st, p, lr=torch.tensor(0.1))
    assert p2 is p and st2.m is st.m and st2.v is st.v
    assert int(st.step) == 0 and int(st2.step) == 1
    assert all(not torch.equal(a, b) for (_, a), (_, b) in zip(
        tcm.leaves(p), tcm.leaves(before)))
    assert all(t.any() for _, t in tcm.leaves(st.m))


def test_update_in_slices_is_bit_equal(monkeypatch):
    """The update runs each leaf in slices of ``_SLICE`` elements; slices
    that cut leaves anywhere change no number."""
    p, g = _tree(1), _t(_tree(2))
    want = adamw.update(g, adamw.init(_t(p)), _t(p), lr=torch.tensor(0.1))
    monkeypatch.setattr(adamw, "_SLICE", 7)
    got = adamw.update(g, adamw.init(_t(p)), _t(p), lr=torch.tensor(0.1))
    for tree_got, tree_want in ((got[0], want[0]), (got[1].m, want[1].m),
                                (got[1].v, want[1].v)):
        for (path, a), (_, b) in zip(tcm.leaves(tree_got),
                                     tcm.leaves(tree_want)):
            assert torch.equal(a, b), path


def test_global_norm_and_clip_match_reference():
    g = _tree(6, 3.0)
    np.testing.assert_allclose(float(adamw.global_norm(_t(g))),
                               float(jadamw.global_norm(_j(g))), **TOL6)
    tc, tn = adamw.clip_by_global_norm(_t(g), 1.0)
    jc, jn = jadamw.clip_by_global_norm(_j(g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), **TOL6)
    _close(tc, jc, **TOL6)


@pytest.mark.parametrize("name", ["warmup_cosine", "constant"])
def test_schedules_match_reference(name):
    kw = dict(peak_lr=3e-4, warmup_steps=20, total_steps=100)
    steps = [0, 1, 10, 19, 20, 21, 50, 99, 100, 150]
    got = schedule.SCHEDULES[name](torch.tensor(steps, dtype=torch.int32),
                                   **kw)
    want = jschedule.SCHEDULES[name](jnp.asarray(steps, jnp.int32), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7,
                               atol=0)
    if name == "warmup_cosine":
        # warmup, peak and end
        assert float(got[0]) == 0.0
        np.testing.assert_allclose(float(got[4]), 3e-4, rtol=1e-7)
        np.testing.assert_allclose(float(got[8]), 3e-5, rtol=1e-6)


def test_schedule_on_a_scalar_step():
    got = schedule.warmup_cosine(torch.tensor(3, dtype=torch.int32),
                                 peak_lr=1.0, warmup_steps=0,
                                 total_steps=4)
    want = jschedule.warmup_cosine(jnp.int32(3), peak_lr=1.0,
                                   warmup_steps=0, total_steps=4)
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_matches_reference(seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(4097) * 10 ** rng.uniform(-6, 3)).astype(np.float32)
    x[:5] = [0.0, -0.0, x.max(), -x.max(), 0.5 * x.max()]
    q, s = compress.quantize(torch.from_numpy(x))
    jq, js = jcompress.quantize(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(s), float(js), rtol=1e-7, atol=0)
    np.testing.assert_allclose(compress.dequantize(q, s).numpy(),
                               np.asarray(jcompress.dequantize(jq, js)),
                               rtol=1e-7, atol=0)


def test_quantize_rounds_half_to_even():
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
    q, s = compress.quantize(x)
    jq, _ = jcompress.quantize(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.tolist()[1:] == [0, 2, 2, 0, -2]


def test_compress_grads_matches_reference():
    g, e = _tree(7), _tree(8, 0.01)
    for _ in range(3):
        tg, te = compress.compress_grads(_t(g), _t(e))
        jg, je = jcompress.compress_grads(_j(g), _j(e))
        _close(tg, jg, rtol=1e-6, atol=1e-7)
        _close(te, je, rtol=1e-6, atol=1e-7)
        g, e = _tree(9), tcm.tree_map(lambda _, t: t.numpy(), te)
    z = compress.init_error(_t(g))
    assert all(t.dtype == torch.float32 and not t.any()
               for _, t in tcm.leaves(z))


def test_quantize_dequantize_bounds():
    x = torch.from_numpy(np.random.RandomState(0).standard_normal(
        1000).astype(np.float32))
    q, s = compress.quantize(x)
    err = torch.abs(compress.dequantize(q, s) - x)
    assert float(err.max()) <= float(s) * 0.5 + 1e-6


def test_adamw_step_direction():
    params = {"w": torch.ones((4,), dtype=torch.float32)}
    grads = {"w": torch.tensor([1.0, -1.0, 0.0, 2.0])}
    st = adamw.init(params)
    p2, st2, _ = adamw.update(grads, st, params, lr=0.1, weight_decay=0.0)
    # sign(update) == -sign(grad) on first step (params updated in place)
    assert p2["w"][0] < 1.0 and p2["w"][1] > 1.0 and p2["w"][3] < 1.0
    assert float(p2["w"][2]) == 1.0
    assert int(st2.step) == 1
