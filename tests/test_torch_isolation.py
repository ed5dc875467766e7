"""The port stands alone: no JAX and nothing of the JAX package at run time,
no silent CPU fallback, and loud errors for what is not ported yet."""
from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.core import engine as teng
from repro_torch.core.trace import synthetic_trace

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_simulate_runs_without_jax_in_process():
    code = (
        "import sys\n"
        "from repro_torch.core import engine\n"
        "from repro_torch.core.trace import synthetic_trace\n"
        "tr = synthetic_trace(6, 3, seed=1)\n"
        "spec, params = engine.make_cloud(n_pm=2, n_vm=4, pm_cores=4.0,\n"
        "                                 pm_sched='ondemand')\n"
        "res = engine.simulate(spec, tr, params, device='cpu')\n"
        "assert int(res.n_events) > 0 and not bool(res.overflow)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    spec, params = teng.make_cloud(n_pm=2, n_vm=4, pm_cores=4.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teng.simulate(spec, synthetic_trace(4, 2, seed=0), params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teng.init_state(spec, synthetic_trace(4, 2, seed=0), params)


@pytest.mark.parametrize("pm_sched", ["consolidate", "defrag", "evacuate"])
def test_unported_pm_policies_raise(pm_sched):
    spec, params = teng.make_cloud(n_pm=2, n_vm=4, pm_cores=4.0,
                                   pm_sched=pm_sched)
    assert params.pm_sched == ("alwayson", "ondemand", "consolidate",
                               "defrag", "evacuate").index(pm_sched)
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        teng.simulate(spec, synthetic_trace(4, 2, seed=0), params,
                      device="cpu")


def test_compaction_is_not_ported():
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        teng.make_cloud(n_pm=2, n_vm=4, compact=8)
    # auto and off both run the dense path
    assert teng.make_cloud(n_pm=2, n_vm=4, compact=-1)[0].compact == -1
    assert teng.make_cloud(n_pm=2, n_vm=4, compact=0)[0].compact == 0


def test_backend_switch_has_no_counterpart():
    with pytest.raises(TypeError, match="backend"):
        teng.make_cloud(n_pm=2, n_vm=4, backend="pallas")
