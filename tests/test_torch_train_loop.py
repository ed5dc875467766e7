"""The port's training loop, checkpoints and launchers on the CPU, mirroring
``tests/test_train_ckpt.py`` (the reference's checks on the port: the loss
decreases, ``accum=2`` equals ``accum=1``, the checkpoint round trip, async
writes and GC, resume equal to an uninterrupted run, compression error
feedback), plus checkpoints that cross between the two packages in both
directions, ``launch.train`` with an injected failure and ``--resume``,
and ``launch.serve --ckpt-dir``.

The reduced ``granite-3-2b`` in f32 at B = 4, T = 32, as the reference's
test.  The accumulation check keeps the reference test's tolerance (rtol
2e-3, atol 2e-4 after 3 steps: microbatch means round otherwise than the
batch mean); resume and checkpoint round trips are exact on the CPU.
"""
from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.train import step as jstep
from repro.train.ckpt import Checkpointer as JCheckpointer
from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.train import step as step_mod
from repro_torch.train.ckpt import Checkpointer
from test_torch_train_step import at

ARCH = "granite-3-2b"


@pytest.fixture(scope="module")
def tiny():
    cfg = configs.get_reduced(ARCH)
    return cfg, step_mod.init_state(cfg, 0, device="cpu")


def clone(state):
    return cm.tree_map(lambda _, t: t.clone(), state)


def _loop(cfg, state, steps, *, accum=1, seed=0, lr=1e-2, start=0,
          total=None):
    train_step = step_mod.make_train_step(
        cfg, accum=accum, peak_lr=lr, warmup_steps=5,
        total_steps=total or steps, xent_chunk=16)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=seed)
    losses = []
    for i in range(start, steps):
        state, metrics = train_step(state, make_batch(dcfg, i,
                                                      model_cfg=cfg))
        losses.append(float(metrics["loss"]))
    return state, losses


def assert_trees_equal(a, b):
    pa, pb = cm.leaves(a), cm.leaves(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert torch.equal(x, y), path


def test_init_state_is_f32_in_the_reference_nesting():
    cfg = configs.get_reduced(ARCH, compute_dtype="bfloat16")
    jcfg = jconfigs.get_reduced(ARCH, compute_dtype="bfloat16")
    state = step_mod.init_state(cfg, 0, use_compression=True, device="cpu")
    ref = jstep.init_state(jcfg, jax.random.PRNGKey(0),
                           use_compression=True)
    assert sorted(state) == sorted(ref) == ["err", "opt", "params"]
    assert isinstance(state["opt"], adamw.AdamWState)
    pairs = cm.leaves(state)
    assert len(pairs) == len(jax.tree.leaves(ref))
    for path, t in pairs:
        want = at(ref, path)
        assert tuple(t.shape) == want.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(want.dtype), path
    assert int(state["opt"].step) == 0
    assert not any(t.any() for _, t in cm.leaves(state["opt"].m))
    meta = step_mod.init_state(cfg, 0, device="meta")
    assert all(t.is_meta for _, t in cm.leaves(meta))
    assert "err" not in meta


def test_loss_decreases(tiny):
    cfg, state = tiny
    _, losses = _loop(cfg, clone(state), 15)
    assert losses[-1] < losses[0] - 0.1, losses
    assert all(np.isfinite(losses))


def test_grad_accum_matches_full_batch(tiny):
    """accum=2 over the same global batch == accum=1 (same grads/step)."""
    cfg, state0 = tiny
    s1, l1 = _loop(cfg, clone(state0), 3, accum=1)
    s2, l2 = _loop(cfg, clone(state0), 3, accum=2)
    np.testing.assert_allclose(l1, l2, rtol=1e-5)
    for (path, a), (_, b) in zip(cm.leaves(s1["params"]),
                                 cm.leaves(s2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=2e-4, err_msg=str(path))


def test_ckpt_roundtrip(tmp_path, tiny):
    cfg, state = tiny
    ck = Checkpointer(tmp_path, keep=2)
    ck.save(state, 7)
    restored, step = ck.restore(state)
    assert step == 7
    assert_trees_equal(restored, state)
    onto_meta, _ = ck.restore(step_mod.init_state(cfg, 1, device="meta"),
                              device="cpu")
    assert_trees_equal(onto_meta, state)


def test_ckpt_async_and_gc(tmp_path, tiny):
    cfg, state = tiny
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save_async(state, s)
    ck.wait()
    steps = sorted(p.name for p in tmp_path.glob("step_*.npz"))
    assert len(steps) == 2 and steps[-1] == "step_00000004.npz"
    assert ck.latest_step() == 4
    assert not list(tmp_path.glob("*.tmp"))


def test_save_async_snapshots_before_returning(tmp_path, tiny):
    """The train step updates the state in place; a checkpoint taken before
    a step holds the state of before the step."""
    cfg, state0 = tiny
    state = clone(state0)
    ck = Checkpointer(tmp_path)
    ck.save_async(state, 1)
    state, _ = _loop(cfg, state, 2)
    ck.wait()
    restored, _ = ck.restore(state0)
    assert_trees_equal(restored, state0)


def test_resume_reproduces_uninterrupted_run(tmp_path, tiny):
    """ckpt at step 5 + 5 more steps == 10 straight steps (data keyed by
    step counter makes the loader position implicit)."""
    cfg, state0 = tiny
    s_straight, _ = _loop(cfg, clone(state0), 10)
    s_half, _ = _loop(cfg, clone(state0), 5, total=10)
    ck = Checkpointer(tmp_path)
    ck.save(s_half, 5)
    restored, _ = ck.restore(step_mod.init_state(cfg, 0, device="meta"),
                             device="cpu")
    state, _ = _loop(cfg, restored, 10, start=5)
    assert_trees_equal(state, s_straight)


def test_compression_error_feedback_converges():
    """int8 EF-compressed training still reduces the loss."""
    cfg = configs.get_reduced(ARCH)
    state = step_mod.init_state(cfg, 2, use_compression=True, device="cpu")
    train_step = step_mod.make_train_step(
        cfg, accum=1, peak_lr=1e-2, warmup_steps=2, total_steps=12,
        use_compression=True, xent_chunk=16)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=1)
    losses = []
    for i in range(12):
        state, metrics = train_step(state, make_batch(dcfg, i,
                                                      model_cfg=cfg))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.1
    # error buffers are actually nonzero (feedback active)
    assert float(adamw.global_norm(state["err"])) > 0


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jcfg = jconfigs.get_reduced(ARCH)
    ref = jstep.init_state(jcfg, jax.random.PRNGKey(5),
                           use_compression=True)
    ref["opt"] = ref["opt"]._replace(step=ref["opt"].step + 3)
    JCheckpointer(tmp_path).save(ref, 3)
    cfg = configs.get_reduced(ARCH)
    target = step_mod.init_state(cfg, 0, use_compression=True,
                                 device="meta")
    got, step = Checkpointer(tmp_path).restore(target, device="cpu")
    assert step == 3
    pairs = cm.leaves(got)
    assert len(pairs) == len(jax.tree.leaves(ref))
    for path, t in pairs:
        want = at(ref, path)
        assert str(t.dtype).removeprefix("torch.") == str(want.dtype), path
        np.testing.assert_array_equal(t.numpy(), want, err_msg=str(path))
    assert int(got["opt"].step) == 3


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    cfg = configs.get_reduced(ARCH)
    state = step_mod.init_state(cfg, 4, use_compression=True, device="cpu")
    train_step = step_mod.make_train_step(cfg, use_compression=True,
                                          xent_chunk=16)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    state, _ = train_step(state, make_batch(dcfg, 0, model_cfg=cfg))
    Checkpointer(tmp_path).save(state, 1)
    jcfg = jconfigs.get_reduced(ARCH)
    got, step = JCheckpointer(tmp_path).restore(
        jstep.abstract_state(jcfg, use_compression=True))
    assert step == 1 and int(got["opt"].step) == 1
    pairs = cm.leaves(state)
    assert len(pairs) == len(jax.tree.leaves(got))
    for path, t in pairs:
        want = at(got, path)
        assert str(t.dtype).removeprefix("torch.") == str(want.dtype), path
        np.testing.assert_array_equal(t.numpy(), want, err_msg=str(path))


def test_restore_casts_to_the_serving_storage_dtypes(tmp_path, tiny):
    cfg, state = tiny
    Checkpointer(tmp_path).save(state, 2)
    bf = configs.get_reduced(ARCH, compute_dtype="bfloat16")
    target = {"params": lm.init_params(bf, 0, device="meta")}
    got, _ = Checkpointer(tmp_path).restore(target, device="cpu")
    src = dict(cm.leaves(state["params"]))
    for path, t in cm.leaves(got["params"]):
        assert t.dtype == cm.storage_dtype(path, "bfloat16"), path
        assert torch.equal(t, src[path].to(t.dtype)), path
    assert got["params"]["embed"].dtype == torch.bfloat16
    assert got["params"]["final_norm"]["w"].dtype == torch.float32


def _train_args(ckpt_dir, *more):
    return ["--arch", ARCH, "--reduced", "--steps", "8", "--batch", "4",
            "--seq", "32", "--ckpt-every", "2", "--log-every", "3",
            "--xent-chunk", "16", "--ckpt-dir", str(ckpt_dir), "--device",
            "cpu", *more]


def test_launch_train_fail_at_and_resume(tmp_path, capsys):
    straight, broken = tmp_path / "straight", tmp_path / "broken"
    assert train_mod.main(_train_args(straight)) == 0
    assert train_mod.main(_train_args(broken, "--fail-at", "5")) == 42
    out = capsys.readouterr().out
    assert "INJECTED FAILURE at step 5" in out
    assert Checkpointer(broken).latest_step() == 4
    assert train_mod.main(_train_args(broken, "--resume")) == 0
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "done: 8 steps" in out
    cfg = configs.get_reduced(ARCH)
    target = step_mod.init_state(cfg, 0, device="meta")
    a, sa = Checkpointer(straight).restore(target, device="cpu")
    b, sb = Checkpointer(broken).restore(target, device="cpu")
    assert sa == sb == 8
    assert_trees_equal(a, b)
    # a resume that finds the run finished runs no step
    assert train_mod.main(_train_args(broken, "--resume")) == 0
    assert "done: 8 steps, 0 stragglers, final loss nan" in (
        capsys.readouterr().out)


@pytest.mark.parametrize("target", ["adamw.update",
                                    "compress.compress_grads"])
def test_launch_train_stops_on_a_partial_update(tmp_path, capsys,
                                                monkeypatch, target):
    """A step that fails once it has begun writing the state (the error
    buffer, the parameters or the moments) raises ``PartialUpdateError``
    and is not retried: a retry would run on a partly updated state.  The
    checkpoint in flight is written before the error leaves the run."""
    from repro_torch.optim import compress

    mod, name = {"adamw": adamw, "compress": compress}[
        target.split(".")[0]], target.split(".")[1]
    real, calls = getattr(mod, name), []

    def broken(grads, state, *a, **kw):
        calls.append(1)
        if len(calls) == 3:         # the third step writes, then fails
            next(t for _, t in cm.leaves(state)
                 if t.is_floating_point()).add_(1.0)
            raise RuntimeError("injected failure inside the update")
        return real(grads, state, *a, **kw)

    monkeypatch.setattr(mod, name, broken)
    with pytest.raises(step_mod.PartialUpdateError, match="injected"):
        train_mod.main(_train_args(tmp_path, "--compress", "--retries",
                                   "2"))
    assert len(calls) == 3
    assert "retrying" not in capsys.readouterr().out
    assert Checkpointer(tmp_path).latest_step() == 2


def test_launch_train_retries_a_failed_backward(tmp_path, capsys,
                                                monkeypatch):
    """A step that fails in its forward or backward is retried from the
    state as it was, and the run ends as an unbroken one."""
    assert train_mod.main(_train_args(tmp_path / "straight")) == 0
    real, calls = step_mod.loss_and_grads, []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 4:
            raise RuntimeError("injected failure in the backward")
        return real(*a, **kw)

    monkeypatch.setattr(step_mod, "loss_and_grads", flaky)
    assert train_mod.main(_train_args(tmp_path / "flaky")) == 0
    assert "step 3 attempt 0 failed: injected" in capsys.readouterr().out
    target = step_mod.init_state(configs.get_reduced(ARCH), 0, device="meta")
    a, _ = Checkpointer(tmp_path / "straight").restore(target, device="cpu")
    b, _ = Checkpointer(tmp_path / "flaky").restore(target, device="cpu")
    assert_trees_equal(a, b)


def test_launch_train_compress_and_accum(tmp_path, capsys):
    args = _train_args(tmp_path, "--compress", "--accum", "2")
    assert train_mod.main(args) == 0
    out = capsys.readouterr().out
    assert "done: 8 steps" in out and "final loss" in out
    state, _ = Checkpointer(tmp_path).restore(step_mod.init_state(
        configs.get_reduced(ARCH), 0, use_compression=True, device="meta"),
        device="cpu")
    assert int(state["opt"].step) == 8
    assert float(adamw.global_norm(state["err"])) > 0


def test_launch_train_needs_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mod.main(["--arch", ARCH, "--reduced", "--steps", "1"])


def test_launch_serve_from_checkpoint(tmp_path, capsys):
    assert train_mod.main(_train_args(tmp_path)) == 0
    capsys.readouterr()
    assert serve_mod.main(["--arch", ARCH, "--ckpt-dir", str(tmp_path),
                           "--device", "cpu", "--requests", "3",
                           "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "restored params from step 8" in out
    assert "3 requests | 12 tokens" in out


def test_training_runs_with_jax_blocked(tmp_path):
    """``train``, ``optim``, ``data`` and both launchers run with every
    import of JAX or the reference refused (``test_torch_isolation.py``
    checks the sources' imports, these modules included)."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None      # any import of them now fails\n"
        "from repro_torch.launch import serve, train\n"
        f"d = {str(tmp_path)!r}\n"
        "args = ['--arch', 'rwkv6-3b', '--reduced', '--steps', '2',\n"
        "        '--batch', '2', '--seq', '16', '--compress',\n"
        "        '--ckpt-dir', d, '--device', 'cpu']\n"
        "assert train.main(args) == 0\n"
        "assert serve.main(['--arch', 'rwkv6-3b', '--ckpt-dir', d,\n"
        "                   '--device', 'cpu', '--requests', '2']) == 0\n"
        "print('ok')\n")
    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
