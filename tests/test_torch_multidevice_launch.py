"""``launch.train`` on a mesh of ``gloo`` ranks of the CPU under torchrun
(``tests/test_multidevice.py``'s elastic re-carve, through the port's
launcher): ``--device cpu --mesh 2x2 --fail-at 3`` on four ranks, then
``--resume --mesh 2x1`` on two, gives the losses of an uninterrupted run
on one device; only rank 0 prints.  A step that fails on one rank of a
mesh is not retried: that rank prints its failure and raises, and the run
fails.

On this CPU the first step on the 2x2 mesh takes most of the time: it is
when DTensor plans each redistribution (a search over placements), which
it caches for the later steps.
"""
from __future__ import annotations

import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch.multiprocessing as mp

import _torch_mesh_ranks as ranks

SRC = str(Path(__file__).resolve().parent.parent / "src")


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp, *argv, nproc=0):
    base = ["-m", "repro_torch.launch.train", "--arch", "granite-3-2b",
            "--reduced", "--steps", "6", "--ckpt-dir", str(tmp / "ck"),
            "--ckpt-every", "1", "--log-every", "1", "--device", "cpu",
            *argv]
    cmd = [sys.executable] + (
        ["-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
         "--master-port", str(_port())] if nproc else []) + base
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=300)
    losses = {int(s): l for s, l in re.findall(r"step (\d+) loss=(\S+)",
                                               r.stdout)}
    return r, losses


def test_launcher_resumes_on_a_smaller_mesh(tmp_path):
    r, first = _launch(tmp_path, "--mesh", "2x2", "--fail-at", "3",
                       nproc=4)
    assert r.returncode != 0, r.stdout
    assert "INJECTED FAILURE at step 3" in r.stdout, r.stdout + r.stderr
    assert "mesh={'data': 2, 'model': 2}" in r.stdout
    assert r.stdout.count("step 0 loss=") == 1          # rank 0 alone
    r, resumed = _launch(tmp_path, "--mesh", "2x1", "--resume", nproc=2)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    assert "resumed from step 3" in r.stdout
    assert sorted(first) == [0, 1, 2] and sorted(resumed) == [3, 4, 5]
    r, whole = _launch(tmp_path / "plain")
    assert r.returncode == 0, r.stderr[-3000:]
    assert {**first, **resumed} == whole


def test_a_rank_that_fails_fails_the_run(tmp_path, capfd):
    """Rank 1 of a 2x1 mesh fails in the backward of its third step: no
    rank retries it (a retry on one rank would pair its collectives with
    the others' wrongly), rank 1 prints its failure, and the run fails."""
    argv = ["--arch", "granite-3-2b", "--reduced", "--steps", "4",
            "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "1",
            "--log-every", "1", "--device", "cpu", "--mesh", "2x1",
            "--retries", "2"]
    with pytest.raises((mp.ProcessRaisedException,
                        mp.ProcessExitedException)):
        mp.spawn(ranks.launch_entry, args=(2, _port(), argv, 1, 3),
                 nprocs=2, join=True)
    out, err = capfd.readouterr()
    assert "rank 1: step 2 failed: injected failure" in err, err[-3000:]
    assert "retrying" not in out + err
    assert "step 1 loss=" in out and "step 2 loss=" not in out
