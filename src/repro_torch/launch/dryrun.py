"""Dry run: build every (arch x shape) cell's step on ``meta`` tensors and
count what it executes (port of ``repro/launch/dryrun.py``).

For each cell the abstract arguments come from the configs' shapes
(``meta`` tensors: shapes and dtypes, no storage), the partition specs of
every leaf from the rule tables, and the step runs once under
:class:`repro_torch.launch.op_cost.OpCount`, which counts the products'
FLOPs, the pointwise FLOPs, the bytes each op moves and the peak of live
bytes.  Nothing touches a device and no kernel runs: the cells take the
configs' plain attention path (``attn_impl="chunked"``), as the
reference's dry run keeps its pure-jnp path.

Each record (one JSON a cell under ``--out``) keeps the reference's schema,
so that either package's ``sched.energy_aware.load_cells`` and
``benchmarks/roofline.py`` read either package's records:
``arch``, ``shape``, ``mesh``, ``ok``, ``skipped``, ``params_total``,
``params_active``, ``model_flops``, ``mesh_shape``, ``collectives`` (zero on
one device; :func:`collective_bytes`) and the counts under ``hlo_cost``;
and adds ``counter`` (``"torch_dispatch"``: counted from the eager ops,
not from HLO), ``memory``
(argument, output and in-place-aliased bytes, and the counted peak as
``temp_size_in_bytes``) and ``pspecs`` (each argument leaf's partition
spec).

A cell on a mesh of more than one device runs in this one process under
a fake process group of ``mesh.size`` ranks (``launch.mesh.init_fake``):
its arguments are ``meta`` DTensors on their partition specs' placements,
the step runs inside ``dist.sharding.act_ctx``, and the count is one
rank's: each op at its local shapes, the collectives DTensor issues by
kind with their operand bytes, and the memory of the local shards.  The
production meshes are ``single`` (16x16) and ``multi`` (2x16x16), the
default, as the reference's; ``1x1`` is the one device.

    python -m repro_torch.launch.dryrun --out DIR [--arch A,B] [--shape S]
        [--mesh single,multi,1x1,2x4]
"""
from __future__ import annotations

import argparse
import collections
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.configs.shapes import (ENCDEC_DECODE_SRC, SHAPES,
                                        input_specs, skip_reason)
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import make_production_mesh, parse_mesh
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.train import step as train_step_mod

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def collective_bytes(counter: op_cost.OpCount) -> dict:
    """Per-collective operand bytes and counts of one counted run, in the
    reference's record: ``{kind: {"bytes", "count"}, "total_bytes"}``
    (``collective-permute``, which DTensor does not issue, stays 0)."""
    out = {k: {"bytes": int(counter.collective_bytes.get(k, 0)),
               "count": int(counter.collective_counts.get(k, 0))}
           for k in _COLLECTIVES}
    out["total_bytes"] = sum(v["bytes"] for v in out.values())
    return out


def active_params(cfg) -> tuple[int, int]:
    """(total, active) parameter counts; active scales expert weights by
    top_k/n_experts (the 6*N_active*D MoE convention)."""
    spec = lm.lm_spec(cfg)
    total = cm.count_params(spec)
    if cfg.n_experts and cfg.top_k:
        expert = 0
        for blk in spec["blocks"]:
            ffn = blk.get("ffn", {})
            for name in ("w_gu", "w_down"):
                if name in ffn and "experts" in ffn[name].axes:
                    expert += cm.count_params(ffn[name])
        active = total - expert + expert * cfg.top_k // cfg.n_experts
    else:
        active = total
    return total, active


def model_flops(cfg, shape) -> float:
    """6*N_active*D for training, 2*N_active*D for inference steps."""
    _, active = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * active * shape.batch * shape.seq
    if shape.kind == "prefill":
        return 2.0 * active * shape.batch * shape.seq
    return 2.0 * active * shape.batch  # decode: one token per sequence


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------


def build_cell(cfg, shape, mesh, *, accum: int = 8, rules_train=None,
               rules_serve=None, xent_chunk: int = 512):
    """Returns (fn, abstract_args, pspecs): the step, its ``meta``
    arguments, and each argument's partition specs on ``mesh``.

    train: ``make_train_step(cfg, accum, xent_chunk)`` on
    ``abstract_state`` and the batch; prefill: ``lm.prefill`` on the
    parameters the port serves with (``lm.init_params`` on ``meta``: each
    leaf at its storage dtype, where the reference's dry run casts every
    leaf to the compute dtype; torch's products do not promote mixed
    dtypes, and the port's model reads its f32 leaves as f32), the batch
    and an empty cache; decode:
    ``lm.decode_step`` of the cache's last position, ``seq - 1`` (one new
    token against a full cache of ``seq``; the reference's traced index
    makes its attention scan every chunk of the cache, as this does).
    On a mesh the serving steps return their logits replicated, as the
    reference's cells give them out (``out_shardings``); the train step's
    metrics are replicated already."""
    rules_train = rules_train or shd.TRAIN_RULES
    rules_serve = rules_serve or shd.SERVE_RULES
    specs = input_specs(cfg, shape)

    if shape.kind == "train":
        batch = specs["batch"]
        state = train_step_mod.abstract_state(cfg)
        pspecs = (shd.tree_pspecs(train_step_mod.state_axes(cfg), state,
                                  mesh, rules_train),
                  shd.tree_pspecs(shd.batch_axes(batch), batch, mesh,
                                  rules_train))
        step = train_step_mod.make_train_step(cfg, accum=accum,
                                              xent_chunk=xent_chunk)
        return step, (state, batch), pspecs

    params = lm.init_params(cfg, 0, device="meta")
    params_ps = shd.tree_pspecs(cm.logical_axes(lm.lm_spec(cfg)), params,
                                mesh, rules_serve)
    cache = specs["cache"]

    if shape.kind == "prefill":
        batch = specs["batch"]
        enc_len = shape.seq if cfg.is_encdec else 0
        cache_ps = shd.tree_pspecs(
            lm.cache_axes(cfg, shape.batch, shape.seq, enc_len=enc_len),
            cache, mesh, rules_serve)

        def fn(params, batch, cache):
            logits, cache = lm.prefill(cfg, params, batch, cache)
            return shd.replicate(logits), cache

        return fn, (params, batch, cache), (
            params_ps, shd.tree_pspecs(shd.batch_axes(batch), batch, mesh,
                                       rules_serve), cache_ps)

    # decode
    cache = dict(cache, index=shape.seq - 1)
    enc_len = ENCDEC_DECODE_SRC if cfg.is_encdec else 0
    cache_ps = shd.tree_pspecs(
        lm.cache_axes(cfg, shape.batch, shape.seq, enc_len=enc_len), cache,
        mesh, rules_serve)
    tok_ps = shd.pspec_for(("batch", None), specs["tokens"].shape, mesh,
                           rules_serve)

    def fn(params, tokens, cache):
        logits, cache = lm.decode_step(cfg, params, tokens, cache)
        return shd.replicate(logits), cache

    return fn, (params, specs["tokens"], cache), (params_ps, tok_ps, cache_ps)


def materialize(args, device, *, vocab: int, seed: int = 0):
    """Real tensors of ``args``'s shapes and dtypes on ``device`` (integer
    leaves, the token ids, uniform in ``[0, vocab)``; float leaves standard
    normal; from ``seed``); host numbers kept.  A cell counted on them runs
    the ops it runs on ``args``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(_, t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.dtype.is_floating_point:
            return torch.randn(t.shape, generator=gen, dtype=t.dtype,
                               device=device)
        return torch.randint(0, vocab, t.shape, generator=gen, dtype=t.dtype,
                             device=device)

    return cm.tree_map(make, args)


def _flat_specs(specs, prefix=()) -> dict:
    """``{"a/b/0/c": spec}``: a spec tree's leaves by path (a spec is a
    plain tuple; a named tuple such as ``AdamWState`` is a node)."""
    if isinstance(specs, dict):
        items = specs.items()
    elif isinstance(specs, list) or hasattr(specs, "_fields"):
        items = zip(getattr(specs, "_fields", None)
                    or map(str, range(len(specs))), specs)
    else:
        return {"/".join(prefix): list(specs)}
    out = {}
    for k, v in items:
        out.update(_flat_specs(v, prefix + (k,)))
    return out


def _mesh_of(mesh_name: str):
    """``single`` / ``multi``: the production meshes; ``AxB`` / ``AxBxC``:
    a mesh of those sizes (``1x1`` is :func:`host_mesh`'s)."""
    if mesh_name == "single":
        return make_production_mesh(multi_pod=False)
    if mesh_name == "multi":
        return make_production_mesh(multi_pod=True)
    return parse_mesh(mesh_name)


def _on_mesh(args, pspecs, dm):
    """``args`` as ``meta`` DTensors on ``pspecs``' placements on the
    DeviceMesh ``dm`` (host numbers kept)."""
    def one(arg, ps):
        lone = isinstance(arg, torch.Tensor)     # a lone tensor and spec
        tree, specs = ({"x": arg}, {"x": ps}) if lone else (arg, ps)
        out = shd.distribute(tree, cm.tree_map(
            lambda _, p: (dm, shd.placements(p, dm)), specs,
            is_leaf=shd.is_spec))
        return out["x"] if lone else out

    return tuple(one(a, ps) for a, ps in zip(args, pspecs))


def measure(cfg, shape, mesh, *, accum: int = 8, rules_train=None,
            rules_serve=None) -> dict:
    """The counted part of a record: build the cell (:func:`build_cell`)
    and run it once under :class:`~repro_torch.launch.op_cost.OpCount`;
    on a mesh of more devices as one rank of a fake process group of
    ``mesh.size`` ranks (module docstring), which is ended after."""
    t0 = time.perf_counter()
    fn, args, pspecs = build_cell(cfg, shape, mesh, accum=accum,
                                  rules_train=rules_train,
                                  rules_serve=rules_serve)
    rec = {"build_s": time.perf_counter() - t0,
           "pspecs": [_flat_specs(s) for s in pspecs]}
    t0 = time.perf_counter()
    if mesh.size > 1:
        rules = ((rules_train or shd.TRAIN_RULES) if shape.kind == "train"
                 else (rules_serve or shd.SERVE_RULES))
        mesh_mod.init_fake(mesh)
        try:
            dm = mesh_mod.device_mesh(mesh, "meta")
            args = _on_mesh(args, pspecs, dm)
            with op_cost.OpCount(args) as counter:
                with shd.act_ctx(dm, rules):
                    out = fn(*args)
        finally:
            torch.distributed.destroy_process_group()
    else:
        out, counter = op_cost.count(fn, *args)
    rec["run_s"] = time.perf_counter() - t0
    rec["hlo_cost"] = counter.summary()
    rec["collectives"] = collective_bytes(counter)
    rec["memory"] = {
        "argument_size_in_bytes": op_cost.tree_nbytes(args),
        "output_size_in_bytes": op_cost.tree_nbytes(out),
        "alias_size_in_bytes": counter.aliased_bytes,
        "temp_size_in_bytes": counter.peak_bytes,
    }
    return rec


def run_cell(arch: str, shape_name: str, mesh_name: str = "1x1", *,
             mesh=None, accum: int = 8, cfg_overrides=None,
             rules_train=None, rules_serve=None) -> dict:
    """One cell's record: the published config of ``arch`` (with
    ``cfg_overrides``) at ``SHAPES[shape_name]``, counted by
    :func:`measure`."""
    cfg = configs.get(arch, **(cfg_overrides or {}))
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "ok": False, "counter": "torch_dispatch"}
    skip = skip_reason(cfg, shape)
    if skip:
        rec.update(skipped=skip, ok=True)
        return rec
    if mesh is None:
        mesh = _mesh_of(mesh_name)
    total, active = active_params(cfg)
    rec.update(params_total=total, params_active=active,
               model_flops=model_flops(cfg, shape),
               mesh_shape={k: int(v) for k, v in mesh.shape.items()})
    if cfg_overrides:
        rec["cfg_overrides"] = dict(cfg_overrides)
    before = collections.Counter(shd.FALLBACKS)
    rec.update(measure(cfg, shape, mesh, accum=accum,
                       rules_train=rules_train, rules_serve=rules_serve))
    # the ops this cell ran replicated for want of a DTensor strategy
    rec["fallbacks"] = dict(shd.FALLBACKS - before)
    rec["ok"] = "error" not in rec
    return rec


def _parse_overrides(pairs) -> dict:
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("True", "False"):
            v = v == "True"
        overrides[k] = v
    return overrides


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Dry run: count every (arch x shape) cell on meta "
                    "tensors")
    ap.add_argument("--arch", default="all",
                    help="arch id, comma list, or 'all'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single,multi",
                    help="comma list of 'single' (16x16), 'multi' "
                         "(2x16x16), '1x1' (one device) or 'AxB' / "
                         "'AxBxC'")
    ap.add_argument("--accum", type=int, default=8)
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="", help="suffix for result files")
    ap.add_argument("--set", action="append", default=[],
                    help="ModelConfig override key=value")
    ap.add_argument("--train-rules", default="train",
                    choices=sorted(shd.RULE_SETS))
    ap.add_argument("--serve-rules", default="serve",
                    choices=sorted(shd.RULE_SETS))
    args = ap.parse_args(argv)

    overrides = _parse_overrides(args.set)
    archs = list(configs.ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    failures = 0
    for mesh_name in args.mesh.split(","):
        mesh = _mesh_of(mesh_name)
        for arch in archs:
            for shape_name in shapes:
                tag = f"{arch}_{shape_name}_{mesh_name}{args.tag}"
                try:
                    rec = run_cell(arch, shape_name, mesh_name, mesh=mesh,
                                   accum=args.accum, cfg_overrides=overrides,
                                   rules_train=shd.RULE_SETS[args.train_rules],
                                   rules_serve=shd.RULE_SETS[args.serve_rules])
                except Exception as e:  # record, keep going
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "ok": False,
                           "counter": "torch_dispatch",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                (outdir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
                status = ("SKIP" if rec.get("skipped")
                          else ("ok" if rec["ok"] else "FAIL"))
                extra = ""
                if rec.get("hlo_cost"):
                    extra = (f" dot_flops={rec['hlo_cost']['dot_flops']:.3e}"
                             f" run={rec['run_s']:.1f}s")
                print(f"[{status}] {tag}{extra}", flush=True)
                failures += 0 if rec["ok"] else 1
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
