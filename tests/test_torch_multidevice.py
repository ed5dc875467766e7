"""The port on a mesh of ``gloo`` ranks of the CPU against the reference's
sharded runs (``tests/test_multidevice.py``'s problems).

The port's ranks are spawned by ``torch.multiprocessing``, one thread
each (``tests/_torch_mesh_ranks.py``); the reference runs after them in a
subprocess of its own with eight forced host devices and its mesh axes
``Auto`` (jax 0.9 makes them ``Explicit`` by default, under which its
``act_ctx`` constraints do not lower), never beside the ranks.

(a) the reduced granite-moe train step on 2x4, ``accum=2``, four steps:
    losses and parameters against the reference's sharded run and the
    port's unsharded run at ``test_torch_train_step``'s ``TOL``; each
    rank's embedding shard is smaller than the whole; only ops of
    ``FALLBACK_OPS`` ran replicated; the int8 compression
    of a gradient sharded over the 2x4 ranks equal to the unsharded one
    bit for bit;
(b) a state saved on 4x2 (eight ranks) restored on 2x2 (four ranks) is
    bit-equal to ``init_state(cfg, 7)``; the reference's 4x2 checkpoint
    restores on the port's 2x2 and the port's on the reference's 2x2;
(c) ``gpipe`` over four ranks equals sequential application within 2e-5,
    and the reference's ``gpipe`` on a four-device mesh.

The launcher on a mesh is ``tests/test_torch_multidevice_launch.py``'s.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_mesh_ranks as ranks
from repro_torch import configs
from repro_torch.dist import sharding as shd
from repro_torch.models import common as cm
from repro_torch.train import step as tstep
from test_torch_lm_dense import TOL

SRC = str(Path(__file__).resolve().parent.parent / "src")


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(fn: str, world: int, *args):
    mp.spawn(ranks.entry, args=(world, _port(), fn, args), nprocs=world,
             join=True)


REF = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.data.pipeline import DataConfig, make_batch
from repro.dist import pipeline, sharding as shd
from repro.train import step as step_mod
from repro.train.ckpt import Checkpointer

out = sys.argv[1]
STEPS, ACCUM, XENT, LR, SEQ, BATCH = {steps}, {accum}, {xent}, {lr}, {seq}, {batch}
auto = lambda n: (jax.sharding.AxisType.Auto,) * n
devs = jax.devices()

# (a) the sharded step from the port's initial state
cfg = configs.get_reduced("{arch_step}")
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=auto(2))
abs_state = step_mod.abstract_state(cfg)
sh = shd.tree_shardings(step_mod.state_axes(cfg), abs_state, mesh,
                        shd.TRAIN_RULES)
state, _ = Checkpointer(out + "/init").restore(abs_state, shardings=sh)
step = step_mod.make_train_step(cfg, accum=ACCUM, peak_lr=LR,
                                xent_chunk=XENT)
def in_ctx(state, batch):
    with shd.act_ctx(mesh, shd.TRAIN_RULES):
        return step(state, batch)
ts = jax.jit(in_ctx, in_shardings=(sh, None), out_shardings=(sh, None),
             donate_argnums=(0,))
dcfg = DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)
losses = []
for i in range(STEPS):
    batch = {{k: jnp.asarray(v) for k, v in
             make_batch(dcfg, i, model_cfg=cfg).items()}}
    state, m = ts(state, batch)
    losses.append(float(m["loss"]))
assert len(state["params"]["embed"].sharding.device_set) > 1
Checkpointer(out + "/ref_sharded").save(state, STEPS)

# (b) a 4x2 checkpoint of the reference's; the port's onto a 2x2 mesh
ccfg = configs.get_reduced("{arch_ckpt}")
m42 = jax.make_mesh((4, 2), ("data", "model"), axis_types=auto(2))
sh42 = shd.tree_shardings(step_mod.state_axes(ccfg),
                          step_mod.abstract_state(ccfg), m42, shd.TRAIN_RULES)
st7 = jax.device_put(step_mod.init_state(ccfg, jax.random.PRNGKey(7)), sh42)
Checkpointer(out + "/ref_4x2").save(st7, 5)
m22 = jax.make_mesh((2, 2), ("data", "model"), axis_types=auto(2),
                    devices=devs[:4])
cabs = step_mod.abstract_state(ccfg)
sh22 = shd.tree_shardings(step_mod.state_axes(ccfg), cabs, m22,
                          shd.TRAIN_RULES)
got, step_no = Checkpointer(out + "/port_4x2").restore(cabs, shardings=sh22)
assert step_no == 5
zf = np.load(out + "/port_4x2/step_00000005.npz")
for path, leaf in jax.tree_util.tree_flatten_with_path(got)[0]:
    key = "/".join(str(getattr(p, "key", getattr(p, "name", getattr(
        p, "idx", p)))) for p in path)
    np.testing.assert_array_equal(np.asarray(leaf), zf[key])
    assert len(leaf.sharding.device_set) == 4

# (c) gpipe on a mesh of four devices
pipe = np.load(out + "/pipe_inputs.npz")
m4 = jax.make_mesh((4,), ("stage",), axis_types=auto(1), devices=devs[:4])
run = pipeline.gpipe(lambda p, x: jnp.tanh(x @ p["w"] + p["b"]), m4,
                     "stage", 4)
np.save(out + "/pipe_ref.npy",
        np.asarray(run({{"w": pipe["w"], "b": pipe["b"]}}, pipe["xs"])))
print("REF_OK", json.dumps(losses))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's eight ranks, then the reference, then the port's four
    ranks, in that order (each reads what the one before wrote)."""
    out = tmp_path_factory.mktemp("mesh")
    rng = np.random.RandomState(0)
    np.savez(out / "pipe_inputs.npz",
             w=rng.normal(size=(ranks.S, ranks.D, ranks.D)).astype(
                 np.float32) * 0.3,
             b=rng.normal(size=(ranks.S, ranks.D)).astype(np.float32) * 0.1,
             xs=rng.normal(size=(ranks.M, ranks.MB, ranks.D)).astype(
                 np.float32))
    _spawn("sharded_step_and_save", 8, str(out))
    code = REF.format(steps=ranks.STEPS, accum=ranks.ACCUM,
                      xent=ranks.XENT_CHUNK, lr=ranks.LR, seq=ranks.SEQ,
                      batch=ranks.BATCH, arch_step=ranks.ARCH_STEP,
                      arch_ckpt=ranks.ARCH_CKPT)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", code, str(out)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert "REF_OK" in r.stdout, r.stdout + r.stderr[-3000:]
    ref_losses = json.loads(r.stdout.split("REF_OK", 1)[1])
    _spawn("restore_2x2_and_gpipe", 4, str(out))
    return out, ref_losses


def _params(npz):
    with np.load(npz) as zf:
        return {k: zf[k] for k in zf.files if k.startswith("params/")}


def test_sharded_train_step_2x4(runs):
    out, ref_losses = runs
    recs = json.loads((out / "sharded.json").read_text())
    losses = recs[0]["losses"]
    assert all(r["losses"] == losses for r in recs)      # every rank
    np.testing.assert_allclose(losses, ref_losses, **TOL)
    assert all(np.isfinite(losses)), losses
    for r in recs:      # the embedding really is spread over the ranks
        assert np.prod(r["local"]) * 8 == np.prod(r["whole"]), r
        assert set(r["fallbacks"]) <= shd.FALLBACK_OPS, r["fallbacks"]
    got = _params(out / "sharded" / f"step_{ranks.STEPS:08d}.npz")
    ref = _params(out / "ref_sharded" / f"step_{ranks.STEPS:08d}.npz")
    assert set(got) == set(ref) and len(got) > 5
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], **TOL, err_msg=k)

    cfg = configs.get_reduced(ranks.ARCH_STEP)
    state = tstep.init_state(cfg, 0, device="cpu")
    plain = []
    for i in range(ranks.STEPS):
        state, met = ranks.train_step(cfg, state, i)
        plain.append(float(met["loss"]))
    np.testing.assert_allclose(losses, plain, **TOL)
    for path, t in cm.leaves(state["params"]):
        k = "params/" + "/".join(path)
        np.testing.assert_allclose(got[k], t.numpy(), **TOL, err_msg=k)


def test_elastic_reshard_restore(runs):
    """Saved on 4x2 by eight ranks, restored on 2x2 by four, bit-equal to
    init_state(cfg, 7); the checkpoints cross between the packages both
    ways (asserted inside the ranks and the reference's run)."""
    out, _ = runs
    for d in ("port_4x2", "ref_4x2"):
        assert (out / d / "step_00000005.npz").exists()
        assert (out / d / "LATEST").read_text().strip() == "5"
    assert not list(out.glob("port_4x2/*.tmp"))


def test_pipeline_parallel(runs):
    out, _ = runs
    got = np.load(out / "pipe_port.npy")
    np.testing.assert_allclose(got, np.load(out / "pipe_ref.npy"),
                               rtol=2e-5, atol=2e-5)
    pipe = np.load(out / "pipe_inputs.npz")
    seq = pipe["xs"]
    for s in range(ranks.S):
        seq = np.tanh(seq @ pipe["w"][s] + pipe["b"][s])
    np.testing.assert_allclose(got, seq, rtol=2e-5, atol=2e-5)
