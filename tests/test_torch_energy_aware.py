"""The port's ``sched/energy_aware.py`` and ``ensemble.job_mix_ensemble``
against the reference's, with the reference's own chip figures passed in
(``REF``), so that both packages compute the same thing.

``CellPerf``, ``roofline_terms`` and ``load_cells`` equal; ``job_trace``,
``default_job_mix`` and ``job_mix_ensemble`` bit-equal;
``pod_power_table`` and ``fleet_params`` equal leaf for leaf;
``evaluate_schedulers`` on the reference's ``_fake_cells`` trace
(``tests/test_hlo_cost_sched.py``) with ``n_pods=4``: every row equal,
integers exactly and floats within rtol 1e-5 / atol 1e-6.  The default
H100 record against numbers worked out by hand.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.experiments import ensemble as jens
from repro.sched import energy_aware as jea
from repro_torch.experiments import ensemble as tens
from repro_torch.sched import energy_aware as ea

RTOL, ATOL = 1e-5, 1e-6
REF = ea.Chip(name="reference", peak_flops=jea.PEAK_FLOPS,
              hbm_bw=jea.HBM_BW, link_bw=jea.ICI_BW, idle_w=jea.CHIP_IDLE_W,
              peak_w=jea.CHIP_PEAK_W, per_pm=jea.POD_CHIPS)


def _fake_cells(mod):
    """tests/test_hlo_cost_sched.py ``_fake_cells``, of either package."""
    return {
        ("archA", "train_4k"): mod.CellPerf("archA", "train_4k",
                                            0.8, 0.3, 0.2),
        ("archB", "train_4k"): mod.CellPerf("archB", "train_4k",
                                            0.2, 0.5, 0.1),
        ("archB", "decode_32k"): mod.CellPerf("archB", "decode_32k",
                                              0.001, 0.004, 0.002),
    }


def _bits(x) -> bytes:
    return np.asarray(x, np.float32).tobytes()


def _same_trace(got, want):
    assert got.gid is None
    for k in ("arrival", "cores", "work"):
        assert _bits(getattr(got, k)) == _bits(getattr(want, k)), k


@pytest.mark.parametrize("terms", [(0.8, 0.3, 0.2), (0.2, 0.5, 0.1),
                                   (0.001, 0.004, 0.002), (0.1, 0.1, 0.3),
                                   (0.0, 0.0, 0.0)])
def test_cellperf_matches_reference(terms):
    got, want = ea.CellPerf("a", "s", *terms), jea.CellPerf("a", "s", *terms)
    assert got.step_s == want.step_s
    assert got.bottleneck == want.bottleneck
    assert got.utilisation == want.utilisation


def _record(arch, shape, mesh, dot, nbytes, coll, **kw):
    return dict(arch=arch, shape=shape, mesh=mesh, ok=True,
                hlo_cost={"dot_flops": dot, "bytes_accessed": nbytes,
                          "collective_total_bytes": coll}, **kw)


def test_roofline_and_load_cells_match_reference(tmp_path):
    recs = [_record("a1", "train_4k", "1x1", 3.1e15, 2.2e12, 0.0),
            _record("a1", "decode_32k", "1x1", 4.0e12, 9.5e11, 1.0e9),
            _record("a2", "prefill_32k", "1x1", 7.7e14, 1.3e12, 5.0e10),
            _record("a2", "train_4k", "single", 1.0e15, 1.0e12, 1.0e11),
            dict(arch="a3", shape="long_500k", mesh="1x1", ok=True,
                 skipped="full attention"),
            dict(arch="a4", shape="train_4k", mesh="1x1", ok=False,
                 error="boom")]
    for r in recs:
        (tmp_path / f"{r['arch']}_{r['shape']}_{r['mesh']}.json").write_text(
            json.dumps(r))
    for r in recs[:4]:
        assert ea.roofline_terms(r, chip=REF) == jea.roofline_terms(r)
    for mesh in ("1x1", "single"):
        got = ea.load_cells(tmp_path, mesh=mesh, chip=REF)
        want = jea.load_cells(tmp_path, mesh=mesh)
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            assert dataclasses.astuple(got[key]) == dataclasses.astuple(w)
    assert sorted(ea.load_cells(tmp_path, chip=REF)) == [
        ("a1", "decode_32k"), ("a1", "train_4k"), ("a2", "prefill_32k")]


def test_h100_roofline_by_hand():
    """One record on the default chip: 1.9788e15 FLOP at 989.4 TFLOP/s is
    2 s, 1.675e12 B at 3.35 TB/s is 0.5 s, 4.5e11 B at 450 GB/s is 1 s."""
    rec = _record("a", "s", "1x1", 1.9788e15, 1.675e12, 4.5e11)
    c, m, k = ea.roofline_terms(rec)
    assert abs(c - 2.0) < 1e-12 and abs(m - 0.5) < 1e-12
    assert abs(k - 1.0) < 1e-12
    perf = ea.CellPerf("a", "s", c, m, k)
    assert perf.bottleneck == "compute" and perf.utilisation == 1.0
    assert ea.H100.per_pm == 8 and ea.H100.peak_w == 700.0
    assert 0.0 < ea.H100.idle_w < ea.H100.peak_w
    table = ea.pod_power_table()
    assert float(table.p_max[2]) == 8 * 700.0
    assert float(table.p_min[2]) == np.float32(8 * ea.H100.idle_w)
    assert ea.fleet_params().pm_cores == 8.0


def test_job_trace_and_mix_bit_equal():
    cells, jcells = _fake_cells(ea), _fake_cells(jea)
    for n_jobs, seed in ((24, 0), (7, 3), (40, 11)):
        jobs = ea.default_job_mix(cells, n_jobs=n_jobs, seed=seed)
        jjobs = jea.default_job_mix(jcells, n_jobs=n_jobs, seed=seed)
        assert [dataclasses.astuple(j) for j in jobs] == [
            dataclasses.astuple(j) for j in jjobs]
        for spread in (600.0, 5.0):
            _same_trace(ea.job_trace(jobs, cells, arrival_spread_s=spread,
                                     seed=seed, chip=REF),
                        jea.job_trace(jjobs, jcells, arrival_spread_s=spread,
                                      seed=seed))
    # a job of a cell without a record is left out, and a job may take
    # more than one node
    jobs = [ea.Job("archA", "train_4k", 100, pods=2), ea.Job("x", "y", 5)]
    jjobs = [jea.Job("archA", "train_4k", 100, pods=2), jea.Job("x", "y", 5)]
    _same_trace(ea.job_trace(jobs, cells, chip=REF),
                jea.job_trace(jjobs, jcells))
    assert ea.job_trace(jobs, cells).cores.tolist() == [16.0]


def test_job_mix_ensemble_bit_equal():
    got = tens.job_mix_ensemble(_fake_cells(ea), 3, n_jobs=12, seed0=5,
                                chip=REF)
    want = jens.job_mix_ensemble(_fake_cells(jea), 3, n_jobs=12, seed0=5)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same_trace(g, w)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def test_power_table_and_fleet_params_match_reference():
    got, want = ea.pod_power_table(chip=REF), jea.pod_power_table()
    for k in want._fields:
        assert _np(getattr(got, k)).tobytes() == _np(
            getattr(want, k)).tobytes(), k
    p, jp = ea.fleet_params(chip=REF, pm_sched="ondemand"), \
        jea.fleet_params(pm_sched="ondemand")
    for f in dataclasses.fields(jp):
        g, w = getattr(p, f.name), getattr(jp, f.name)
        if hasattr(w, "_fields") or dataclasses.is_dataclass(w):
            names = getattr(w, "_fields", None) or [
                x.name for x in dataclasses.fields(w)]
            for k in names:
                assert _np(getattr(g, k)).tobytes() == _np(
                    getattr(w, k)).tobytes(), (f.name, k)
        else:
            assert g == w, f.name


def test_evaluate_schedulers_rows_match_reference():
    """The reference's test_evaluate_schedulers_energy_ordering trace: two
    long training jobs over 5 s, 4 pods, the 15 policy pairs."""
    cells, jcells = _fake_cells(ea), _fake_cells(jea)
    jobs = [ea.Job("archA", "train_4k", steps=5000),
            ea.Job("archB", "train_4k", steps=8000)]
    jjobs = [jea.Job("archA", "train_4k", steps=5000),
             jea.Job("archB", "train_4k", steps=8000)]
    tr = ea.job_trace(jobs, cells, arrival_spread_s=5.0, chip=REF)
    jtr = jea.job_trace(jjobs, jcells, arrival_spread_s=5.0)
    got = ea.evaluate_schedulers(tr, n_pods=4, chip=REF, devices=["cpu"])
    want = jea.evaluate_schedulers(jtr, n_pods=4)
    assert len(got) == len(want) == 15
    for g, w in zip(got, want):
        assert set(g) == set(w), set(g) ^ set(w)
        for k, v in w.items():
            if isinstance(v, float):
                np.testing.assert_allclose(g[k], v, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{w['vm_sched']}/"
                                                   f"{w['pm_sched']} {k}")
            else:
                assert g[k] == v, (k, g[k], v)


def test_evaluate_schedulers_needs_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    tr = ea.job_trace([ea.Job("archA", "train_4k", 10)], _fake_cells(ea))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ea.evaluate_schedulers(tr, n_pods=2)
