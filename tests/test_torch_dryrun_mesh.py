"""The dry run on meshes of more than one device: the port counts one rank
of a fake process group (``launch.dryrun.measure``), the reference
compiles for forced host devices with ``Auto`` mesh axes
(``tools/dryrun_mesh_compare.py`` runs both, at two layers, ``accum=1``).

* granite-moe and granite-3 at ``decode_32k`` and ``train_4k`` on 2x4:
  a decode cell's per-device ``dot_flops`` within ``test_torch_dryrun``'s
  ``TOL`` of the reference's.  A train cell's are held in two parts, each
  within ``TOL``: the products outside the vocab's dims against the
  reference's, and those at the vocab's dims against an even share of
  the reference's unsharded ones.  GSPMD runs the cross-entropy's
  unembed products whole on each rank of the model axis (the vocab,
  49,155, does not divide it, so the logits' spec leaves it replicated),
  where DTensor splits them over the ranks and gathers after (ROADMAP
  queue 3);
* total collective bytes non-zero wherever the reference's are, and within
  a factor of 4 of them;
* all ten architectures at ``decode_32k`` on the 16x16 ``single`` mesh
  give ``ok`` records, which both packages' ``load_cells(dir, "single")``
  read;
* a cell counted twice in a fresh process gives the same counts: the ops
  DTensor's sharding propagation tries on global-shape fake tensors the
  first time it meets an op are not counted.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

from repro.sched import energy_aware as jea
from repro_torch import configs
from repro_torch.dist import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.sched import energy_aware as ea
from test_torch_dryrun import TOL

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import dryrun_mesh_compare as cmp  # noqa: E402

CELLS = [f"{a}/{s}" for a, s in cmp.CELLS]


@pytest.fixture(scope="module")
def rows():
    return cmp.compare(cmp.CELLS, "2x4", layers=2)


@pytest.mark.parametrize("cell", CELLS)
def test_per_device_dot_flops_against_reference(rows, cell):
    row = rows[cell]
    port, ref = row["port"]["dot_flops"], row["reference"]["dot_flops"]
    assert port > 0 and ref > 0
    assert set(row["port"]["fallbacks"]) <= shd.FALLBACK_OPS, row
    if cell.endswith("decode_32k"):
        assert abs(port / ref - 1.0) <= TOL["decode"], row
    else:
        assert abs(row["dot_flops_ratio_outside_vocab_products"]
                   - 1.0) <= TOL["train"], row
        assert abs(row["vocab_dot_flops_over_share"] - 1.0) <= TOL["train"], row


@pytest.mark.parametrize("cell", CELLS)
def test_collective_bytes_against_reference(rows, cell):
    row = rows[cell]
    port = row["port"]["collective_total_bytes"]
    ref = row["reference"]["collective_total_bytes"]
    assert ref > 0, row
    assert port > 0, row
    assert 1 / 4 <= port / ref <= 4, row
    kinds = set(row["port"]["collective_bytes"])
    assert kinds <= {"all-gather", "all-reduce", "reduce-scatter",
                     "all-to-all"}, kinds
    assert sum(row["port"]["collective_bytes"].values()) == port


def test_ten_archs_decode_on_single(tmp_path):
    """Every architecture's decode_32k cell on the 16x16 mesh (two layers)
    through the CLI; both packages' load_cells read every record."""
    rc = dryrun.main(["--arch", "all", "--shape", "decode_32k", "--mesh",
                      "single", "--set", "n_layers=2", "--accum", "1",
                      "--out", str(tmp_path)])
    assert rc == 0
    assert not dist.is_initialized()        # each cell ended its group
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert len(recs) == len(configs.ARCHS)
    for rec in recs:
        assert rec["ok"] and not rec.get("skipped"), rec.get("error")
        assert rec["mesh_shape"] == {"data": 16, "model": 16}
        assert rec["hlo_cost"]["dot_flops"] > 0
        assert rec["collectives"]["total_bytes"] > 0
        assert set(rec["fallbacks"]) <= shd.FALLBACK_OPS, rec["fallbacks"]
    cells = ea.load_cells(tmp_path)             # the default: "single"
    jcells = jea.load_cells(tmp_path, "single")
    assert sorted(cells) == sorted(jcells) == sorted(
        (a, "decode_32k") for a in configs.ARCHS)
    for key, c in cells.items():
        assert c.collective_s > 0
        assert c.collective_s == pytest.approx(
            jcells[key].collective_s * jea.ICI_BW / ea.H100.link_bw)


def test_count_does_not_depend_on_dtensor_cache():
    code = (
        "import json\n"
        "from repro_torch.launch import dryrun\n"
        "keys = ('dot_flops', 'elem_flops', 'bytes_accessed', 'n_ops',\n"
        "        'collective_total_bytes', 'peak_bytes')\n"
        "recs = [dryrun.run_cell('granite-moe-1b-a400m', 'decode_32k',\n"
        "                        '2x2', cfg_overrides={'n_layers': 1})\n"
        "        for _ in range(2)]\n"
        "print(json.dumps([{k: r['hlo_cost'][k] for k in keys}\n"
        "                  for r in recs]))\n")
    env = dict(os.environ, PYTHONPATH=cmp.SRC)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    first, second = json.loads(r.stdout.strip().splitlines()[-1])
    assert first == second
    assert first["dot_flops"] > 0 and first["collective_total_bytes"] > 0
