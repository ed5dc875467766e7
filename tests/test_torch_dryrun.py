"""The dry-run layer: the port's ``launch.op_cost``, ``launch.dryrun``,
``configs.shapes`` and the abstract trees against the reference's
(``launch/hlo_cost.py`` on XLA's optimized HLO, ``ShapeDtypeStruct`` trees).

* ``op_cost`` gives exactly the product FLOPs of the four programs of
  ``tests/test_hlo_cost_sched.py``, on ``meta`` and on real tensors;
* ``input_specs``, ``abstract``, ``abstract_state`` and ``cache_struct``
  match the reference's shapes and dtypes, and the axes trees its axes;
* ``active_params`` and ``model_flops`` are exact;
* a reduced cell's product FLOPs, counted on ``meta`` tensors, against the
  reference's HLO count of the cell it builds (compiled without
  shardings), rel 2e-2 for train and prefill, 5e-2 for decode; its
  argument bytes equal the reference's abstract inputs.

The train cells run two cross-entropy chunks (``xent_chunk=16`` at seq
32): at one chunk XLA merges the checkpointed unembed with its forward,
which the last test pins down exactly.
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.launch import dryrun as jdry
from repro.launch import hlo_cost
from repro.launch import mesh as jmesh
from repro.models import common as jcm
from repro.models import lm as jlm
from repro.sched import energy_aware as jea
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.launch import dryrun, op_cost
from repro_torch.launch.mesh import host_mesh
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.sched import energy_aware as ea
from repro_torch.train import step as tstep

ARCHS = list(configs.ARCHS)
CELL_ARCHS = ["granite-3-2b", "granite-moe-1b-a400m", "jamba-v0.1-52b",
              "rwkv6-3b", "seamless-m4t-large-v2", "paligemma-3b"]
TOL = {"train": 2e-2, "prefill": 2e-2, "decode": 5e-2}


# ---------------------------------------------------------------- op_cost

def _scan(a, b):
    c = a
    for _ in range(10):
        c = c @ b
    return c


def _nested(a, b):
    c = a
    for _ in range(3):
        for _ in range(5):
            c = c @ b
    return c


PROGRAMS = {   # name: (fn, input shapes, dot_flops of the reference's test)
    "scan_trip_multiplied": (_scan, [(128, 128), (128, 128)],
                             10 * 2 * 128 ** 3),
    "nested_scan": (_nested, [(64, 64), (64, 64)], 15 * 2 * 64 ** 3),
    "plain_matmul_and_elementwise": (lambda a, b: torch.tanh(a @ b),
                                     [(32, 64), (64, 16)], 2 * 32 * 64 * 16),
    "batched_dot_general": (
        lambda a, b: torch.einsum("bik,bkj->bij", a, b),
        [(4, 32, 64), (4, 64, 16)], 2 * 4 * 32 * 64 * 16),
}


@pytest.mark.parametrize("device", ["meta", "cpu"])
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_op_cost_dot_flops_exact(name, device):
    fn, shp, want = PROGRAMS[name]
    args = [torch.randn(s, device=device) for s in shp]
    r = op_cost.analyze(fn, *args)
    assert r["dot_flops"] == want
    assert r["bytes_accessed"] > 0
    assert r["collective_total_bytes"] == 0.0
    if name == "plain_matmul_and_elementwise":
        assert r["elem_flops"] >= 32 * 16   # the tanh
        assert r["peak_bytes"] == 2 * 32 * 16 * 4   # product and tanh live
        top = op_cost.breakdown(fn, *args, top_n=1)
        assert top[0]["op"] == "mm" and top[0]["dot_flops"] == want


def test_op_cost_aliased_bytes_and_views():
    """An in-place write into an argument counts its storage once; a view
    moves no bytes."""
    x = torch.empty(8, 16, device="meta")
    with op_cost.OpCount((x,)) as c:
        x[2:4].add_(1.0)
        x.t()
    assert c.aliased_bytes == 8 * 16 * 4
    assert c.by_op["t"]["bytes"] == 0.0
    assert c.peak_bytes == 0


# ---------------------------------------------------------------- trees

def _flat(tree, prefix=""):
    """{path: leaf} over dicts (sorted), lists and named tuples."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if hasattr(tree, "_fields"):
        out = {}
        for k in tree._fields:
            out.update(_flat(getattr(tree, k), f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _sd(leaf):
    """(shape, dtype name) of a ShapeDtypeStruct or a meta tensor."""
    if isinstance(leaf, torch.Tensor):
        assert leaf.device.type == "meta"
        return tuple(leaf.shape), str(leaf.dtype).removeprefix("torch.")
    return tuple(leaf.shape), jnp.dtype(leaf.dtype).name


def _assert_same_structs(got, want, host_index=False):
    g, w = _flat(got), _flat(want)
    if host_index:   # the port keeps the cache position as a host int
        for path in [p for p in w if p.endswith("cache/index")
                     or p == "/index"]:
            assert g.pop(path) == 0
            assert _sd(w.pop(path)) == ((), "int32")
    assert set(g) == set(w), set(g) ^ set(w)
    for path in w:
        assert _sd(g[path]) == _sd(w[path]), path


@pytest.mark.parametrize("shape_name", list(shapes.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape_name):
    assert shapes.SHAPES[shape_name] == shapes.ShapeCell(
        **vars(jshapes.SHAPES[shape_name]))
    cfg, jcfg = configs.get_reduced(arch), jconfigs.get_reduced(arch)
    shape = shapes.SHAPES[shape_name]
    assert shapes.skip_reason(cfg, shape) == jshapes.skip_reason(
        jcfg, jshapes.SHAPES[shape_name])
    _assert_same_structs(shapes.input_specs(cfg, shape),
                         jshapes.input_specs(jcfg, jshapes.SHAPES[shape_name]),
                         host_index=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_and_axes_match_reference(arch):
    cfg, jcfg = configs.get_reduced(arch), jconfigs.get_reduced(arch)
    spec, jspec = lm.lm_spec(cfg), jlm.lm_spec(jcfg)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        _assert_same_structs(cm.abstract(spec, dt), jcm.abstract(jspec, jdt))
    assert _flat(cm.logical_axes(spec)) == _flat(jcm.logical_axes(jspec))
    assert all(cm.is_spec(ps) for ps in _flat(spec).values())
    assert not cm.is_spec(cm.logical_axes(spec)["embed"])
    for comp in (False, True):
        _assert_same_structs(
            tstep.abstract_state(cfg, use_compression=comp),
            jstep.abstract_state(jcfg, use_compression=comp))
        assert _flat(tstep.state_axes(cfg, use_compression=comp)) == _flat(
            jstep.state_axes(jcfg, use_compression=comp))
    for enc_len in (0, 24):
        _assert_same_structs(
            lm.cache_struct(cfg, 3, 40, enc_len=enc_len),
            jlm.cache_struct(jcfg, 3, 40, enc_len=enc_len), host_index=True)
        assert _flat(lm.cache_axes(cfg, 3, 40, enc_len=enc_len)) == _flat(
            jlm.cache_axes(jcfg, 3, 40, enc_len=enc_len))


@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_and_model_flops_exact(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    assert dryrun.active_params(cfg) == jdry.active_params(jcfg)
    for name, shape in shapes.SHAPES.items():
        assert dryrun.model_flops(cfg, shape) == jdry.model_flops(
            jcfg, jshapes.SHAPES[name])


# ---------------------------------------------------------------- cells

def _cell(arch, kind):
    """Seq 32, batch 2, accum 2 (paligemma: seq 288, its 256 patches and
    32 tokens); train at two cross-entropy chunks."""
    seq = 288 if arch == "paligemma-3b" else 32
    return (shapes.ShapeCell("cell", kind, seq, 2),
            jshapes.ShapeCell("cell", kind, seq, 2), seq // 2)


def _reference_count(jcfg, jshape, xent_chunk):
    fn, args, *_ = jdry.build_cell(jcfg, jshape, jmesh.host_mesh(), accum=2,
                                   xent_chunk=xent_chunk)
    text = jax.jit(fn).lower(*args).compile().as_text()
    arg_bytes = sum(np.prod(a.shape) * jnp.dtype(a.dtype).itemsize
                    for a in jax.tree.leaves(args))
    return hlo_cost.analyze(text), int(arg_bytes)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_cell_dot_flops_match_reference(arch, kind):
    cfg, jcfg = configs.get_reduced(arch), jconfigs.get_reduced(arch)
    shape, jshape, chunk = _cell(arch, kind)
    want, want_bytes = _reference_count(jcfg, jshape, chunk)
    rec = dryrun.measure(cfg, shape, host_mesh(), accum=2) if kind != (
        "train") else None
    if rec is None:
        fn, args, _ = dryrun.build_cell(cfg, shape, host_mesh(), accum=2,
                                        xent_chunk=chunk)
        out, c = op_cost.count(fn, *args)
        got = c.summary()
        got_bytes = op_cost.tree_nbytes(args)
    else:
        got = rec["hlo_cost"]
        got_bytes = rec["memory"]["argument_size_in_bytes"]
        # the reference's i32 cache index; the port's is a host int
        want_bytes -= 4
    np.testing.assert_allclose(got["dot_flops"], want["dot_flops"],
                               rtol=TOL[kind])
    assert got["collective_total_bytes"] == want["collective_total_bytes"]
    assert got_bytes == want_bytes


def test_one_chunk_cross_entropy_remat_elided_by_xla():
    """At one cross-entropy chunk the reference's HLO counts the unembed
    product once a microbatch: XLA merges the checkpointed recompute with
    the forward.  The port runs (and counts) it twice, as the reference
    does at two chunks."""
    arch = "granite-3-2b"
    cfg, jcfg = configs.get_reduced(arch), jconfigs.get_reduced(arch)
    shape, jshape, _ = _cell(arch, "train")
    want, _ = _reference_count(jcfg, jshape, 512)
    fn, args, _ = dryrun.build_cell(cfg, shape, host_mesh(), accum=2,
                                    xent_chunk=512)
    got = op_cost.analyze(fn, *args)
    micro_tokens = shape.batch // 2 * shape.seq
    unembed = 2 * micro_tokens * cfg.d_model * cfg.vocab
    assert got["dot_flops"] - want["dot_flops"] == 2 * unembed


def test_meta_and_real_tensors_count_the_same():
    """A prefill cell counted on meta tensors and again on real CPU
    tensors of the same shapes and dtypes (what chip_smoke.py does on the
    card)."""
    cfg = configs.get_reduced("granite-3-2b")
    fn, args, _ = dryrun.build_cell(cfg, shapes.ShapeCell("p", "prefill",
                                                          64, 2), host_mesh())
    real = dryrun.materialize(args, "cpu", vocab=cfg.vocab, seed=0)
    a = op_cost.analyze(fn, *args)
    b = op_cost.analyze(fn, *real)
    for k in ("dot_flops", "elem_flops", "bytes_accessed", "n_ops"):
        assert a[k] == b[k], k


def test_dryrun_cli_writes_records_both_packages_read(tmp_path):
    """The CLI on the published configs: a cell skipped, a cell run, the
    same cells on a 2x2 mesh recorded as not run; the port's load_cells
    and the reference's both read the run cell."""
    rc = dryrun.main(["--arch", "granite-3-2b,rwkv6-3b", "--shape",
                      "long_500k", "--mesh", "1x1,2x2", "--out",
                      str(tmp_path)])
    assert rc == 1        # the 2x2 records are failures
    recs = {p.stem: json.loads(p.read_text())
            for p in tmp_path.glob("*.json")}
    assert len(recs) == 4
    skipped = recs["granite-3-2b_long_500k_1x1"]
    assert skipped["ok"] and skipped["skipped"]
    ran = recs["rwkv6-3b_long_500k_1x1"]
    assert ran["ok"] and ran["counter"] == "torch_dispatch"
    assert ran["mesh_shape"] == {"data": 1, "model": 1}
    assert ran["hlo_cost"]["dot_flops"] > 0
    assert ran["collectives"]["total_bytes"] == 0
    assert set(ran["memory"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "alias_size_in_bytes", "temp_size_in_bytes"}
    assert ran["memory"]["alias_size_in_bytes"] > 0      # the cache
    assert ran["pspecs"][0]["embed"] == [None, None]
    multi = recs["rwkv6-3b_long_500k_2x2"]
    assert not multi["ok"] and "item 16" in multi["error"]
    assert "hlo_cost" not in multi
    assert multi["pspecs"][0]["embed"] == ["model", None]   # serve rules
    cells = ea.load_cells(tmp_path, mesh="1x1")
    jcells = jea.load_cells(tmp_path, mesh="1x1")
    assert list(cells) == list(jcells) == [("rwkv6-3b", "long_500k")]
    assert cells[("rwkv6-3b", "long_500k")].compute_s == (
        ran["hlo_cost"]["dot_flops"] / ea.H100.peak_flops)
