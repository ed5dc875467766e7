"""The port's sharding rules and pipeline stages (``dist/sharding.py``,
``dist/pipeline.py``, ``launch/mesh.py``) against the reference's.

``pspec_for`` on the reference's own cases and a hypothesis sweep of
names, dims and mesh shapes, over a JAX ``AbstractMesh`` and the port's
``Mesh`` alike; ``tree_pspecs`` spec for spec against ``tree_shardings``
over a reduced config's parameter, cache and train-state axes; ``gpipe``
against the reference's ``gpipe(..., mesh=None, ...)`` on the problem of
``tests/test_multidevice.py::test_pipeline_parallel``, within 2e-5.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro import configs as jconfigs
from repro.dist import pipeline as jpipe
from repro.dist import sharding as jshd
from repro.models import common as jcm
from repro.models import lm as jlm
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.dist import pipeline as tpipe
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as tmesh
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.train import step as tstep


def _amesh(sizes, names):
    """AbstractMesh across jax versions (>=0.5: (sizes, names);
    0.4.x: tuple of (name, size) pairs)."""
    try:
        return AbstractMesh(sizes, names)
    except TypeError:
        return AbstractMesh(tuple(zip(names, sizes)))


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}

# (names, shape, mesh, rules, the reference test's expected spec)
CASES = [
    (("embed", "mlp"), (4096, 16384), "16x16", "train", P("data", "model")),
    (("batch", "seq"), (256, 4096), "2x16x16", "train",
     P(("pod", "data"), None)),
    (("embed", "kv_heads", "head"), (4096, 8, 128), "16x16", "train",
     P("data", None, None)),
    (("experts", "embed", "mlp"), (16, 4096, 12800), "16x16", "train",
     P("model", "data", None)),
    (("batch", None), (1, 1), "2x16x16", "serve", P(None, None)),
    (("batch", "seq"), (32, 32768), "2x16x16", "serve",
     P(("pod", "data"), None)),
    (("embed", "mlp"), (4096, 16384), "16x16", "serve", P(None, "model")),
    (("batch", "cache_seq", "kv_heads", "head"), (1, 524288, 8, 128),
     "16x16", "serve", P(None, ("model", "data"), None, None)),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_pspec_for_reference_cases(case):
    names, shape, mesh, rules, want = CASES[case]
    sizes, axes = MESHES[mesh]
    for m in (_amesh(sizes, axes), tmesh.make_mesh(sizes, axes)):
        got = shd.pspec_for(names, shape, m, shd.RULE_SETS[rules])
        assert got == tuple(want)
        assert got == tuple(jshd.pspec_for(names, shape, _amesh(sizes, axes),
                                           jshd.RULE_SETS[rules]))


def test_rule_tables_match_reference():
    assert shd.TRAIN_RULES == jshd.TRAIN_RULES
    assert shd.SERVE_RULES == jshd.SERVE_RULES
    assert shd.RULE_SETS == jshd.RULE_SETS
    assert shd._FALLBACK_NAMES == jshd._FALLBACK_NAMES
    assert shd.replicated(tmesh.host_mesh()) == tuple(P())


@settings(max_examples=80, deadline=None)
@given(
    names=st.lists(st.sampled_from(
        ["batch", "embed", "mlp", "q_heads", "kv_heads", "vocab", "experts",
         "seq", "head", "cache_seq", None]), min_size=1, max_size=4),
    dims=st.lists(st.integers(min_value=1, max_value=4096), min_size=4,
                  max_size=4),
    sizes=st.lists(st.sampled_from([1, 2, 3, 4, 8, 16]), min_size=2,
                   max_size=3),
    rules=st.sampled_from(["train", "serve"]),
)
def test_pspec_for_matches_reference_sweep(names, dims, sizes, rules):
    axes = ("pod", "data", "model")[-len(sizes):]
    shape = tuple(dims[:len(names)])
    want = tuple(jshd.pspec_for(names, shape, _amesh(tuple(sizes), axes),
                                jshd.RULE_SETS[rules]))
    for m in (_amesh(tuple(sizes), axes), tmesh.make_mesh(sizes, axes)):
        assert shd.pspec_for(names, shape, m, shd.RULE_SETS[rules]) == want


def _specs(tree):
    """Reference shardings or port specs, flattened in the reference's
    order (dict keys sorted, lists and named tuples in order)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _specs(tree[k])]
    if isinstance(tree, list) or hasattr(tree, "_fields"):
        return [s for v in tree for s in _specs(v)]
    return [tuple(tree.spec) if hasattr(tree, "spec") else tree]


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "jamba-v0.1-52b",
                                  "seamless-m4t-large-v2"])
def test_tree_pspecs_match_tree_shardings(arch):
    cfg, jcfg = configs.get_reduced(arch), jconfigs.get_reduced(arch)
    sizes, axes = MESHES["2x4"]
    jm, tm = _amesh(sizes, axes), tmesh.make_mesh(sizes, axes)
    spec, jspec = lm.lm_spec(cfg), jlm.lm_spec(jcfg)
    pairs = [
        ((cm.logical_axes(spec), cm.abstract(spec)),
         (jcm.logical_axes(jspec), jcm.abstract(jspec)), "serve"),
        ((lm.cache_axes(cfg, 4, 64, enc_len=16),
          lm.cache_struct(cfg, 4, 64, enc_len=16)),
         (jlm.cache_axes(jcfg, 4, 64, enc_len=16),
          jlm.cache_struct(jcfg, 4, 64, enc_len=16)), "serve"),
        ((tstep.state_axes(cfg), tstep.abstract_state(cfg)),
         (jstep.state_axes(jcfg), jstep.abstract_state(jcfg)), "train"),
    ]
    for (axes_t, abs_t), (jaxes_t, jabs_t), rules in pairs:
        got = _specs(shd.tree_pspecs(axes_t, abs_t, tm, shd.RULE_SETS[rules]))
        want = _specs(jshd.tree_shardings(jaxes_t, jabs_t, jm,
                                          jshd.RULE_SETS[rules]))
        assert got == want
        assert any(any(p is not None for p in s) for s in got)
    batch = {"tokens": torch.empty(8, 16, device="meta")}
    assert shd.batch_axes(batch) == {"tokens": ("batch", None)}


# the problem of tests/test_multidevice.py::test_pipeline_parallel
S, M, MB, D = 4, 8, 2, 16


def _pipe_inputs():
    rng = np.random.RandomState(0)
    return (rng.normal(size=(S, D, D)).astype(np.float32) * 0.3,
            rng.normal(size=(S, D)).astype(np.float32) * 0.1,
            rng.normal(size=(M, MB, D)).astype(np.float32))


def test_gpipe_matches_reference():
    Ws, bs, xs = _pipe_inputs()
    want = jpipe.gpipe(lambda p, x: jnp.tanh(x @ p["w"] + p["b"]), None,
                       "stage", S)({"w": Ws, "b": bs}, xs)
    run = tpipe.gpipe(lambda p, x: torch.tanh(x @ p["w"] + p["b"]), None,
                      "stage", S)
    got = run({"w": torch.from_numpy(Ws), "b": torch.from_numpy(bs)},
              torch.from_numpy(xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    seq = xs
    for s in range(S):
        seq = np.tanh(seq @ Ws[s] + bs[s])
    np.testing.assert_allclose(got.numpy(), seq, rtol=2e-5, atol=2e-5)
    one = tpipe.gpipe(lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
                      tmesh.make_mesh((1,), ("stage",)), "stage", S)
    assert torch.equal(one({"w": torch.from_numpy(Ws),
                            "b": torch.from_numpy(bs)},
                           torch.from_numpy(xs)), got)


def test_gpipe_errors():
    Ws, bs, xs = _pipe_inputs()
    run = tpipe.gpipe(lambda p, x: x, None, "stage", S)
    with pytest.raises(ValueError, match=r"stacked to \[4, \.\.\.\]"):
        run({"w": torch.from_numpy(Ws), "b": torch.from_numpy(bs[:3])},
            torch.from_numpy(xs))
    with pytest.raises(ValueError, match="stacked"):
        jpipe.gpipe(lambda p, x: x, None, "stage", S)(
            {"w": Ws, "b": bs[:3]}, xs)
    spread = tpipe.gpipe(lambda p, x: x, tmesh.make_mesh((4,), ("stage",)),
                         "stage", S)   # over ranks: needs their group
    with pytest.raises(RuntimeError, match="no process group"):
        spread({"w": torch.from_numpy(Ws), "b": torch.from_numpy(bs)},
               torch.from_numpy(xs))


def test_meshes():
    assert tmesh.host_mesh().shape == {"data": 1, "model": 1}
    assert tmesh.host_mesh().size == 1
    single = tmesh.make_production_mesh()
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert list(single.shape.items()) == [("data", 16), ("model", 16)]
    assert list(multi.shape.items()) == [("pod", 2), ("data", 16),
                                         ("model", 16)]
    assert multi.size == 512
    with pytest.raises(ValueError, match="differ"):
        tmesh.Mesh(("data",), (2, 2))
