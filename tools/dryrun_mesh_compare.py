"""The dry run on a mesh, the port against the reference, cell by cell.

Each cell (an arch at ``--layers`` layers, a shape, ``accum=1``) is counted
by the port's ``repro_torch.launch.dryrun.run_cell`` under a fake process
group of the mesh's size (in a pool of spawned processes), and by the
reference's ``repro.launch.dryrun.run_cell`` compiled for a mesh of forced
host devices whose axes are ``Auto`` (in a subprocess of its own, run
beside the pool).  Prints one JSON object: per cell, both packages'
per-device ``dot_flops`` and total collective bytes (``hlo_cost``), the
collective bytes by kind, the port's over the reference's, and
``vocab_dot_flops``: the products with the vocab (or its share of one
mesh axis) among their operand or result dims, the reference's from its
optimized HLO (``hlo_cost.breakdown``), the port's from its counted
aten ops.  For a train cell the reference's products at the vocab's dims
on one device are counted too, and the port's are given over an even
share of them (``vocab_dot_flops_over_share``): GSPMD runs those products
whole on each rank of the model axis (the vocab does not divide it),
where the port splits them over every rank.

    PYTHONPATH=src python tools/dryrun_mesh_compare.py [--mesh 2x4]
        [--cells granite-moe-1b-a400m/decode_32k,granite-3-2b/train_4k]
"""
from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import os
import pathlib
import subprocess
import sys

SRC = str(pathlib.Path(__file__).resolve().parent.parent / "src")
CELLS = [("granite-moe-1b-a400m", "decode_32k"),
         ("granite-moe-1b-a400m", "train_4k"),
         ("granite-3-2b", "decode_32k"), ("granite-3-2b", "train_4k")]
KEYS = ("dot_flops", "collective_total_bytes", "collective_bytes")

_REF = r"""
import gzip, json, os, re, sys, tempfile
import jax
from repro import configs
from repro.launch import dryrun, hlo_cost
dims, layers = tuple(int(x) for x in sys.argv[1].split("x")), int(sys.argv[2])
names = ("pod", "data", "model")[-len(dims):]
mesh = jax.make_mesh(dims, names,
                     axis_types=(jax.sharding.AxisType.Auto,) * len(dims))
one = jax.make_mesh((1,) * len(dims), names, devices=jax.devices()[:1],
                    axis_types=(jax.sharding.AxisType.Auto,) * len(dims))


def vocab_dot_flops(arch, shape, mesh, mesh_name):
    # the cell's record and its products at the vocab's dims
    hlo_path = os.path.join(tempfile.mkdtemp(), "cell.hlo.gz")
    rec = dryrun.run_cell(arch, shape, mesh_name, mesh=mesh, accum=1,
                          cfg_overrides={"n_layers": layers},
                          save_hlo_to=hlo_path)
    with gzip.open(hlo_path, "rt") as f:
        text = f.read()
    comps, _ = hlo_cost.parse_hlo(text)
    V = configs.get(arch).vocab
    vocab = {V} | {-(-V // n) for n in dims}
    total = 0.0
    for row in hlo_cost.breakdown(text, top_n=100000):
        if row["kind"] != "dot":
            continue
        op = next(o for o in comps[row["comp"]].ops if o.name == row["op"])
        types = [op.type_str] + [comps[row["comp"]].types.get(x, "")
                                 for x in op.operands]
        sizes = {int(d) for t in types
                 for d in re.findall(r"\d+", "".join(
                     re.findall(r"\[([0-9,]*)\]", t)).replace(",", " "))}
        if sizes & vocab:
            total += row["flops"]
    return rec, total


out = {}
for cell in sys.argv[3].split(","):
    arch, shape = cell.split("/")
    rec, total = vocab_dot_flops(arch, shape, mesh, sys.argv[1])
    out[cell] = {k: rec["hlo_cost"][k] for k in %r}
    out[cell]["vocab_dot_flops"] = total
    if shape.startswith("train"):
        # the same products unsharded, on one device
        out[cell]["vocab_dot_flops_one_device"] = vocab_dot_flops(
            arch, shape, one, "x".join("1" * len(dims)))[1]
print("REF", json.dumps(out))
""" % (KEYS,)


def start_reference(cells, mesh: str, layers: int) -> subprocess.Popen:
    """The reference's counts of ``cells`` on ``mesh``, in a subprocess of
    its own; :func:`reference_result` reads them."""
    n = math.prod(int(x) for x in mesh.split("x"))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n}")
    return subprocess.Popen(
        [sys.executable, "-c", _REF, mesh, str(layers),
         ",".join(f"{a}/{s}" for a, s in cells)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def reference_result(proc: subprocess.Popen, timeout: float = 600) -> dict:
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0 or "REF " not in out:
        raise RuntimeError(f"reference dry run failed: {err[-3000:]}")
    return json.loads(out.split("REF ", 1)[1])


def _port_cell(job) -> dict:
    arch, shape, mesh, layers = job
    sys.path.insert(0, SRC)
    import torch

    from repro_torch import configs
    from repro_torch.launch import dryrun, op_cost
    V = configs.get(arch).vocab
    vocab = {V} | {-(-V // int(n)) for n in mesh.split("x")}
    seen = [0.0]
    dot_flops = op_cost._dot_flops

    def counted(func, args, out):       # the products at the vocab's dims
        f = dot_flops(func, args, out)
        dims = {d for t in [out, *args] if isinstance(t, torch.Tensor)
                for d in t.shape}
        if f and dims & vocab:
            seen[0] += f
        return f

    op_cost._dot_flops = counted
    rec = dryrun.run_cell(arch, shape, mesh, accum=1,
                          cfg_overrides={"n_layers": layers})
    if not rec["ok"]:
        raise RuntimeError(f"{arch}/{shape}: {rec.get('error')}")
    return dict({k: rec["hlo_cost"][k] for k in KEYS},
                vocab_dot_flops=seen[0], fallbacks=rec["fallbacks"])


def port_cells(cells, mesh: str, layers: int, workers: int = 4) -> dict:
    """The port's counts of ``cells`` on ``mesh``, a spawned process a
    cell (at most ``workers`` at once)."""
    with multiprocessing.get_context("spawn").Pool(
            min(workers, len(cells))) as pool:
        recs = pool.map(_port_cell, [(a, s, mesh, layers) for a, s in cells])
    return {f"{a}/{s}": r for (a, s), r in zip(cells, recs)}


def compare(cells=CELLS, mesh: str = "2x4", layers: int = 2,
            workers: int = 4) -> dict:
    """Both packages' counts of every cell and the port's over the
    reference's."""
    ref_proc = start_reference(cells, mesh, layers)
    try:
        port = port_cells(cells, mesh, layers, workers)
    finally:
        ref = reference_result(ref_proc)
    n = math.prod(int(x) for x in mesh.split("x"))
    rows = {}
    for cell in port:
        p, r = port[cell], ref[cell]
        rest = ((p["dot_flops"] - p["vocab_dot_flops"])
                / (r["dot_flops"] - r["vocab_dot_flops"]))
        rows[cell] = {
            "port": p, "reference": r,
            "dot_flops_ratio": p["dot_flops"] / r["dot_flops"],
            "dot_flops_ratio_outside_vocab_products": rest,
            # the port's products at the vocab's dims over an even share
            # of the unsharded ones (train cells, where the port splits
            # them over every rank)
            "vocab_dot_flops_over_share": (
                p["vocab_dot_flops"] * n / r["vocab_dot_flops_one_device"]
                if "vocab_dot_flops_one_device" in r else None),
            "collective_bytes_ratio": (
                p["collective_total_bytes"] / r["collective_total_bytes"]
                if r["collective_total_bytes"] else None)}
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="2x4")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--cells", default=",".join(f"{a}/{s}" for a, s in CELLS))
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args(argv)
    cells = [tuple(c.split("/")) for c in args.cells.split(",")]
    print(json.dumps(compare(cells, args.mesh, args.layers, args.workers),
                     indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
