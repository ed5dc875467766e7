"""The port's DTensor placements (``dist/sharding.py`` on a
``DeviceMesh``) against the reference's shardings, in one process under a
fake process group (``launch.mesh.init_fake``: its collectives move
nothing, so only placements, shapes and local slices are checked here;
the numbers on real ranks are ``tests/test_torch_multidevice.py``'s).

* every train-state and serving leaf (parameters and KV cache) of the ten
  reduced configs, under both rule sets, on 2x4, 4x2, 2x2x2 and 16x16:
  the placements are the reference ``NamedSharding.spec``'s, a mesh axis
  named by dim ``d`` as ``Shard(d)`` and any other as ``Replicate()``;
* ``constrain`` is the identity outside ``act_ctx`` and on a plain
  tensor, and redistributes a DTensor inside it, and its gradient too;
* an op without a DTensor strategy runs replicated only if it is one of
  ``FALLBACK_OPS``;
* ``distribute``: each rank's local shard of a real tensor, gathered by
  hand over the ranks, is bit-equal to the tensor; a ``meta`` tensor
  becomes a DTensor of local ``meta`` shards.
"""
from __future__ import annotations

import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro import configs as jconfigs
from repro.dist import sharding as jshd
from repro.models import common as jcm
from repro.models import lm as jlm
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as tmesh
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.train import step as tstep

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "16x16": ((16, 16), ("data", "model"))}


@pytest.fixture
def fake_mesh():
    """``make(name, rank=0)``: a DeviceMesh of ``MESHES[name]`` as ``rank``
    of a fake group; the group is ended after the test."""
    def make(name, rank=0):
        sizes, axes = MESHES[name]
        m = tmesh.make_mesh(sizes, axes)
        tmesh.init_fake(m, rank=rank)
        return tmesh.device_mesh(m, "cpu")

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def _want(spec, axes):
    """Placements of a reference PartitionSpec on a mesh of ``axes``."""
    dim_of = {}
    for d, entry in enumerate(tuple(spec)):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                dim_of[ax] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in axes)


def _leaves(tree):
    """Reference shardings or port (mesh, placements) pairs, flattened in
    the reference's order (dict keys sorted, lists and named tuples in
    order)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _leaves(tree[k])]
    if isinstance(tree, list) or hasattr(tree, "_fields"):
        return [s for v in tree for s in _leaves(v)]
    return [tree]


def _trees(arch):
    cfg, jcfg = configs.get_reduced(arch), jconfigs.get_reduced(arch)
    spec, jspec = lm.lm_spec(cfg), jlm.lm_spec(jcfg)
    enc = 16 if cfg.is_encdec else 0
    return [
        ((cm.logical_axes(spec), cm.abstract(spec)),
         (jcm.logical_axes(jspec), jcm.abstract(jspec))),
        ((lm.cache_axes(cfg, 16, 64, enc_len=enc),
          lm.cache_struct(cfg, 16, 64, enc_len=enc)),
         (jlm.cache_axes(jcfg, 16, 64, enc_len=enc),
          jlm.cache_struct(jcfg, 16, 64, enc_len=enc))),
        ((tstep.state_axes(cfg), tstep.abstract_state(cfg)),
         (jstep.state_axes(jcfg), jstep.abstract_state(jcfg))),
    ]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_placements_match_reference_shardings(arch, mesh, fake_mesh):
    dm = fake_mesh(mesh)
    sizes, axes = MESHES[mesh]
    am = AbstractMesh(sizes, axes)
    sharded = 0
    for (axes_t, abs_t), (jaxes_t, jabs_t) in _trees(arch):
        for rules in ("train", "serve"):
            got = _leaves(shd.tree_shardings(axes_t, abs_t, dm,
                                             shd.RULE_SETS[rules]))
            want = _leaves(jshd.tree_shardings(jaxes_t, jabs_t, am,
                                               jshd.RULE_SETS[rules]))
            assert len(got) == len(want) > 0
            for (m, places), ref in zip(got, want):
                assert m is dm
                assert places == _want(ref.spec, axes), (rules, ref.spec)
                sharded += any(p.is_shard() for p in places)
    assert sharded > 0


def test_placements_of_specs(fake_mesh):
    dm = fake_mesh("2x2x2")
    assert shd.placements((("pod", "data"), None, "model"), dm) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements((None, None), dm) == (Replicate(),) * 3
    assert shd.placements((), dm) == (Replicate(),) * 3
    assert shd.mesh_shape(dm) == {"pod": 2, "data": 2, "model": 2}
    assert [s.stop - s.start for s in shd.local_index(
        (8, 6, 4), dm, (Shard(0), Shard(0), Shard(2)))] == [2, 6, 2]


def test_constrain_identity_outside_act_ctx(fake_mesh):
    dm = fake_mesh("2x4")
    x = torch.randn(8, 4, 16)
    assert shd.constrain(x, ("batch", "seq", None)) is x
    assert shd.current() is None
    d = shd.distribute({"x": x}, {"x": (dm, (Replicate(), Replicate()))})
    d = d["x"]
    assert shd.constrain(d, ("batch", "seq", None)) is d
    with shd.act_ctx(dm, shd.TRAIN_RULES):
        assert shd.current() == (dm, shd.TRAIN_RULES)
        assert shd.constrain(x, ("batch", "seq", None)) is x   # plain
        y = shd.constrain(d, ("batch", "seq", None))
        assert y.placements == (Shard(0), Replicate())
        assert y.to_local().shape == (4, 4, 16)
        assert shd.constrain(y, ("batch", "seq", None)) is y
    assert shd.current() is None
    assert shd.constrain(d, ("batch", "seq", None)) is d


def test_constrain_pins_the_gradient(fake_mesh):
    """A partial-sum cotangent is reduced at the constraint, also where the
    forward had nothing to move (the reference's sharding constraint
    transposes to the same constraint on the cotangent)."""
    dm = fake_mesh("2x4")
    x = shd.distribute({"x": torch.randn(8, 4)},
                       {"x": (dm, (Shard(0), Replicate()))})["x"]
    x.requires_grad_()
    g = DTensor.from_local(torch.ones(4, 4), dm, (Shard(0), Partial()),
                           run_check=False)
    with shd.act_ctx(dm, shd.TRAIN_RULES):
        y = shd.constrain(x, ("batch", None))
        assert y.placements == x.placements
        (gx,) = torch.autograd.grad(y, x, g)
    assert gx.placements == (Shard(0), Replicate())


def test_fallback_only_for_allowed_ops(fake_mesh, monkeypatch):
    """An op with no DTensor strategy at its placements (a view that would
    split a shard unevenly) runs replicated and is counted when it is one
    of FALLBACK_OPS, and raises, naming the op, when it is not."""
    dm = fake_mesh("2x4")
    x = shd.distribute({"x": torch.randn(8, 4)},
                       {"x": (dm, (Replicate(), Shard(0)))})["x"]
    shd.FALLBACKS.clear()
    with shd.act_ctx(dm, shd.TRAIN_RULES):
        y = x.view(2, 4, 4)
    assert y.placements == (Replicate(), Replicate())
    assert dict(shd.FALLBACKS) == {"view": 1}
    monkeypatch.setattr(shd, "FALLBACK_OPS", shd.FALLBACK_OPS - {"view"})
    with pytest.raises(RuntimeError, match="aten.view.*FALLBACK_OPS"):
        with shd.act_ctx(dm, shd.TRAIN_RULES):
            x.view(2, 4, 4)
    assert dict(shd.FALLBACKS) == {"view": 1}


@pytest.mark.parametrize("mesh", ["2x4", "2x2x2"])
def test_distribute_local_shards_reassemble(mesh, fake_mesh):
    """Every rank's shard of a state leaf, laid out by its placements,
    rebuilds the leaf bit for bit; a meta leaf keeps its global shape."""
    cfg = configs.get_reduced("granite-3-2b")
    state = tstep.init_state(cfg, 7, device="cpu")
    path, leaf = next((p, t) for p, t in cm.leaves(state["params"])
                      if t.ndim == 2 and t.shape[0] % 8 == 0
                      and t.shape[1] % 8 == 0)
    sizes, _ = MESHES[mesh]
    whole = torch.full_like(leaf, float("nan"))
    for rank in range(tmesh.make_mesh(sizes, MESHES[mesh][1]).size):
        dm = fake_mesh(mesh, rank)
        places = (Shard(1),) + (Shard(0),) * (dm.ndim - 1)
        d = shd.distribute({"w": leaf}, {"w": (dm, places)})["w"]
        assert isinstance(d, DTensor) and d.shape == leaf.shape
        idx = [slice(None)] * 2
        for ax, pl in enumerate(places):
            k, n = dm.get_coordinate()[ax], dm.shape[ax]
            size = leaf.shape[pl.dim]
            # shards over several axes of one dim nest in mesh-axis order
            prev = idx[pl.dim]
            start = 0 if prev.start is None else prev.start
            stop = size if prev.stop is None else prev.stop
            step = (stop - start) // n
            idx[pl.dim] = slice(start + k * step, start + (k + 1) * step)
        assert shd.local_index(leaf.shape, dm, places) == tuple(idx)
        whole[tuple(idx)] = d.to_local()
        meta = shd.distribute({"w": torch.empty_like(leaf, device="meta")},
                              {"w": (dm, places)})["w"]
        assert meta.shape == leaf.shape and meta.to_local().is_meta
        assert meta.to_local().shape == d.to_local().shape
        dist.destroy_process_group()
    assert torch.equal(whole, leaf), path
