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
from repro_torch.core.loop.state import TASK_DONE, TASK_REJECTED
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
    assert len(files) > 40
    assert {PORT / "models" / "lm.py", PORT / "serve" / "engine.py",
            PORT / "kernels" / "attention.py",
            PORT / "data" / "pipeline.py",
            PORT / "experiments" / "shard.py",
            PORT / "experiments" / "pareto.py",
            PORT / "experiments" / "ensemble.py",
            PORT / "experiments" / "tournament.py",
            PORT / "core" / "sharing.py", PORT / "core" / "network.py",
            PORT / "core" / "cloud.py", PORT / "models" / "rwkv.py",
            PORT / "configs" / "shapes.py", PORT / "dist" / "sharding.py",
            PORT / "dist" / "pipeline.py", PORT / "launch" / "mesh.py",
            PORT / "launch" / "op_cost.py", PORT / "launch" / "dryrun.py",
            PORT / "sched" / "energy_aware.py",
            PORT / "launch" / "train.py", PORT / "train" / "ckpt.py",
            PORT / "train" / "step.py", PORT / "optim" / "adamw.py",
            PORT / "optim" / "compress.py", PORT / "models" / "moe.py",
            PORT / "models" / "ssm.py", PORT / "kernels" / "ssm.py",
            *(PORT / "configs" / f"{name}.py" for name in (
                "gemma2_27b", "command_r_35b", "granite_3_2b",
                "codeqwen1_5_7b", "granite_moe_1b_a400m", "phi3_5_moe_42b",
                "rwkv6_3b", "seamless_m4t_large_v2", "paligemma_3b"))
            } <= set(files)
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


def test_simulate_batch_runs_with_jax_blocked():
    """The batched path (stack_params, stack_traces, simulate_batch and the
    lane-axis kernel wrappers' plain versions) runs with every import of
    JAX or the reference refused."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None      # any import of them now fails\n"
        "from repro_torch.core import engine\n"
        "from repro_torch.core.trace import synthetic_trace\n"
        "spec, p = engine.make_cloud(n_pm=2, n_vm=4, pm_cores=4.0,\n"
        "                            pm_sched='ondemand', compact=4)\n"
        "import dataclasses\n"
        "pts = [dataclasses.replace(p, net_bw=b, pm_sched=c)\n"
        "       for b, c in ((50.0, 1), (125.0, 2))]\n"
        "trs = engine.stack_traces([synthetic_trace(6, 3, seed=s)\n"
        "                           for s in (1, 2)])\n"
        "res = engine.simulate_batch(spec, trs, engine.stack_params(pts),\n"
        "                            device='cpu')\n"
        "assert res.n_events.shape == (2,) and bool((res.n_events > 1).all())\n"
        "assert res.readings(spec)['iaas_total'].shape == (2,)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_stream_and_experiments_run_with_jax_blocked():
    """The streamed path (chunk_trace, gwa_window_stream, simulate_stream,
    simulate_stream_batch) and the experiments layer run with every
    import of JAX or the reference refused."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None      # any import of them now fails\n"
        "from repro_torch.core import engine\n"
        "from repro_torch.core.trace import chunk_trace, synthetic_trace\n"
        "from repro_torch.data.pipeline import gwa_window_stream\n"
        "from repro_torch.experiments import pareto, shard, tournament\n"
        "spec, p = engine.make_cloud(n_pm=2, n_vm=4, pm_cores=4.0,\n"
        "                            pm_sched='ondemand')\n"
        "tr = synthetic_trace(6, 3, seed=1)\n"
        "res = engine.simulate_stream(spec, chunk_trace(tr, 4), p,\n"
        "                             device='cpu')\n"
        "mono = engine.simulate(spec, tr, p, device='cpu')\n"
        "assert res.completion.tolist() == mono.completion.tolist()\n"
        "g = engine.simulate_stream(spec, gwa_window_stream('das2', 8, 4,\n"
        "                           max_cores=4), p, device='cpu')\n"
        "assert g.completion.shape == (8,)\n"
        "pts = pareto.param_grid(p, net_bw=[50.0, 125.0])\n"
        "b = shard.simulate_stream_batch(spec, chunk_trace(tr, 4),\n"
        "                                engine.stack_params(pts),\n"
        "                                devices=['cpu'])\n"
        "assert b.n_events.shape == (2,)\n"
        "assert len(pareto.sweep(spec, tr, pts, devices=['cpu']).rows) == 2\n"
        "rows = tournament.run(spec, tr, p, schedulers=[(0, 1), (1, 0)],\n"
        "                      devices=['cpu']).rows\n"
        "assert [r['vm_sched'] for r in rows] == ['firstfit', 'nonqueuing']\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_sharing_network_and_cloud_run_with_jax_blocked():
    """The standalone sharing core (a network problem through
    run_sharing and run_sharing_tau) and the IaaS facade run with every
    import of JAX or the reference refused."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None      # any import of them now fails\n"
        "from repro_torch.core import cloud, engine, network, sharing\n"
        "from repro_torch.core.trace import synthetic_trace\n"
        "topo = network.make_topology([50.0, 60.0, 70.0], [40.0, 30.0, 80.0],\n"
        "                             latency=0.01, device='cpu')\n"
        "prob = network.transfers_problem(topo, [0, 1, 2], [1, 2, 0],\n"
        "                                 [100.0, 200.0, 50.0],\n"
        "                                 route_cap=[20.0, 3e38, 3e38])\n"
        "res = sharing.run_sharing(prob, p_idle=[1.0] * 6, p_span=[2.0] * 6)\n"
        "assert bool(res.ok) and int(res.n_events) == 5, res\n"
        "tau = sharing.run_sharing_tau(prob, tau=0.05, n_steps=200)\n"
        "assert (abs(tau - res.completion) <= 0.1).all(), (tau, res)\n"
        "spec, p = engine.make_cloud(n_pm=2, n_vm=4, pm_cores=4.0)\n"
        "tr = synthetic_trace(6, 3, seed=1)\n"
        "r1 = engine.simulate(spec, tr, p, t_stop=20.0, device='cpu')\n"
        "info = cloud.cloud_info(spec, p, r1.state, tr)\n"
        "assert info['pm_total'] == 2 and info['vm_scheduler'] == 'firstfit'\n"
        "st = cloud.deregister_pm(spec, p, r1.state, 0, tr)\n"
        "r2 = engine.simulate(spec, tr, p, state=st, device='cpu')\n"
        "ev = cloud.state_change_events(st, r2.state)\n"
        "assert ev['tasks_completed'] > 0\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_dryrun_and_fleet_run_with_jax_blocked(tmp_path):
    """The dry run (a published config's cell on meta tensors, through the
    CLI), the sharding rules, gpipe and the energy-aware fleet (load_cells
    on the records just written, a job mix, two policy pairs on the CPU)
    run with every import of JAX or the reference refused."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None      # any import of them now fails\n"
        "import torch\n"
        "from repro_torch.dist import pipeline, sharding\n"
        "from repro_torch.launch import dryrun, mesh\n"
        "from repro_torch.sched import energy_aware as ea\n"
        f"out = {str(tmp_path)!r}\n"
        "assert dryrun.main(['--arch', 'rwkv6-3b,jamba-v0.1-52b',\n"
        "                    '--shape', 'decode_32k', '--out', out]) == 0\n"
        "cells = ea.load_cells(out)\n"
        "assert len(cells) == 2, cells\n"
        "tr = ea.job_trace(ea.default_job_mix(cells, n_jobs=6, seed=2),\n"
        "                  cells, arrival_spread_s=60.0, seed=2)\n"
        "rows = ea.evaluate_schedulers(tr, n_pods=2,\n"
        "                              schedulers=[(0, 0), (0, 1)],\n"
        "                              devices=['cpu'])\n"
        "assert [r['jobs_done'] for r in rows] == [6, 6], rows\n"
        "m = mesh.make_mesh((2, 4), ('data', 'model'))\n"
        "assert sharding.pspec_for(('embed', 'mlp'), (64, 64), m,\n"
        "                          sharding.TRAIN_RULES) == ('data', 'model')\n"
        "run = pipeline.gpipe(lambda p, x: x @ p['w'], None, 's', 2)\n"
        "y = run({'w': torch.eye(3).expand(2, 3, 3)}, torch.ones(4, 1, 3))\n"
        "assert torch.equal(y, torch.ones(4, 1, 3))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')\n"
        "             and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_mesh_layer_runs_with_jax_blocked():
    """The mesh layer (a fake group of four ranks: the state placed by
    tree_shardings, a sharded train step under act_ctx with int8
    compression, a dry-run cell on 2x2) runs with every import of JAX or
    the reference refused; the process group and the device mesh refuse
    what they cannot run on."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None      # any import of them now fails\n"
        "import torch\n"
        "from repro_torch import configs\n"
        "from repro_torch.data.pipeline import DataConfig, make_batch\n"
        "from repro_torch.dist import sharding as shd\n"
        "from repro_torch.launch import dryrun, mesh\n"
        "from repro_torch.train import step\n"
        "m = mesh.parse_mesh('2x2')\n"
        "try:\n"
        "    mesh.device_mesh(m, 'cpu')\n"
        "    raise SystemExit('no group: should raise')\n"
        "except RuntimeError as e:\n"
        "    assert 'no process group' in str(e), e\n"
        "mesh.init_fake(mesh.parse_mesh('2x4'))\n"
        "try:\n"
        "    mesh.device_mesh(m, 'cpu')\n"
        "    raise SystemExit('8 ranks for 4: should raise')\n"
        "except ValueError as e:\n"
        "    assert '4 devices' in str(e), e\n"
        "mesh.init_fake(m)\n"
        "dm = mesh.device_mesh(m, 'cpu')\n"
        "cfg = configs.get_reduced('granite-3-2b')\n"
        "st = step.init_state(cfg, 0, use_compression=True, device='cpu')\n"
        "sh = shd.tree_shardings(step.state_axes(cfg, use_compression=True),\n"
        "                        st, dm, shd.TRAIN_RULES)\n"
        "st = shd.distribute(st, sh)\n"
        "ts = step.make_train_step(cfg, use_compression=True)\n"
        "b = make_batch(DataConfig(vocab=cfg.vocab, seq_len=16,\n"
        "                          global_batch=4), 0, model_cfg=cfg)\n"
        "with shd.act_ctx(dm, shd.TRAIN_RULES):\n"
        "    st, met = ts(st, b)\n"
        "assert type(met['loss']) is torch.Tensor\n"
        "assert shd.is_dtensor(st['params']['embed'])\n"
        "torch.distributed.destroy_process_group()\n"
        "rec = dryrun.run_cell('rwkv6-3b', 'decode_32k', '2x2',\n"
        "                      cfg_overrides={'n_layers': 2})\n"
        "assert rec['ok'] and rec['hlo_cost']['dot_flops'] > 0, rec\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')\n"
        "             and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_mesh_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import train as ltrain

    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh.init_from_env()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh.device_mesh(tmesh.host_mesh())
    with pytest.raises(RuntimeError, match="torchrun"):
        ltrain.main(["--arch", "granite-3-2b", "--reduced", "--mesh", "2x2",
                     "--device", "cpu"])


def test_batch_entry_points_need_a_card_or_cpu():
    """``simulate_batch`` runs on CUDA unless asked for the CPU, and never
    falls back to it quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    spec, params = teng.make_cloud(n_pm=2, n_vm=4, pm_cores=4.0)
    trace = teng.stack_traces([synthetic_trace(4, 2, seed=s)
                               for s in (0, 1)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teng.simulate_batch(spec, trace, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        teng.simulate_batch(spec, trace, params, device="cuda")
    res = teng.simulate_batch(spec, trace, params, device="cpu")
    assert res.n_events.device.type == "cpu"


def test_lm_forward_and_serve_run_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None      # any import of them now fails\n"
        "from repro_torch import configs\n"
        "from repro_torch.models import lm\n"
        "from repro_torch.serve.engine import Request, ServeEngine\n"
        "cfg = configs.get_reduced('jamba-v0.1-52b', attn_impl='pallas')\n"
        "params = lm.init_params(cfg, 0, device='cpu')\n"
        "logits, _ = lm.forward(cfg, params, {'tokens': [[3, 1, 4, 1, 5]]})\n"
        "assert logits.shape == (1, 5, cfg.vocab)\n"
        "eng = ServeEngine(cfg, params, batch_size=2, max_len=16,\n"
        "                  eos_id=-1, device='cpu')\n"
        "eng.submit(Request(rid=0, prompt=[2, 3, 4], max_new_tokens=3))\n"
        "eng.submit(Request(rid=1, prompt=[5], max_new_tokens=3))\n"
        "assert eng.run()['tokens'] == 6\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_lm_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine

    cfg = configs.get_reduced("jamba-v0.1-52b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_cache(cfg, 1, 8)
    params = lm.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params, device="cuda")


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
    """PM codes 2-4 raised ``NotImplementedError`` until they were ported;
    the test keeps its name and now runs each policy on the CPU to the end
    of its trace, under its reference code."""
    spec, params = teng.make_cloud(n_pm=2, n_vm=4, pm_cores=4.0,
                                   pm_sched=pm_sched)
    assert params.pm_sched == ("alwayson", "ondemand", "consolidate",
                               "defrag", "evacuate").index(pm_sched)
    trace = synthetic_trace(4, 2, seed=0)
    res = teng.simulate(spec, trace, params, device="cpu")
    assert not bool(res.state.running)
    assert int(res.n_events) > 1 and not bool(res.overflow)
    done = ((res.state.task_state == TASK_DONE)
            | (res.state.task_state == TASK_REJECTED))
    assert bool(done.all())


def test_compaction_is_not_ported():
    """``compact > 0`` raised ``NotImplementedError`` until compaction was
    ported; the test keeps its name and now checks that an explicit
    bucket is accepted and that a value below -1 is refused."""
    assert teng.make_cloud(n_pm=2, n_vm=4, compact=8)[0].compact == 8
    assert teng.make_cloud(n_pm=2, n_vm=4, compact=-1)[0].compact == -1
    assert teng.make_cloud(n_pm=2, n_vm=4, compact=0)[0].compact == 0
    with pytest.raises(ValueError, match="compact"):
        teng.make_cloud(n_pm=2, n_vm=4, compact=-2)


def test_backend_switch_has_no_counterpart():
    with pytest.raises(TypeError, match="backend"):
        teng.make_cloud(n_pm=2, n_vm=4, backend="pallas")
