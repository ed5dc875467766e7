"""Rank programs of ``tests/test_torch_multidevice.py``: each runs in a
process that ``torch.multiprocessing`` spawned, one ``gloo`` rank of the
CPU, and imports only the port (no JAX), so that spawning stays cheap."""
from __future__ import annotations

import json
import os
import pathlib

import numpy as np
import torch
import torch.distributed as dist

ARCH_STEP = "granite-moe-1b-a400m"     # the reference test's sharded step
ARCH_CKPT = "granite-3-2b"             # its elastic reshard
STEPS, ACCUM, XENT_CHUNK, LR = 4, 2, 16, 1e-2
SEQ, BATCH = 32, 8
S, M, MB, D = 4, 8, 2, 16              # its pipeline problem


def entry(rank: int, world: int, port: int, fn: str, args: tuple):
    """The spawned process: one gloo rank, one thread, then ``fn``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as tmesh
    tmesh.init_from_env("cpu")
    try:
        globals()[fn](rank, *args)
    finally:
        dist.destroy_process_group()


def launch_entry(rank: int, world: int, port: int, argv: list,
                 fail_rank: int, fail_call: int):
    """The spawned process: ``launch.train.main(argv)`` as one gloo rank
    (it starts and ends the group), its ``fail_call``-th gradient
    computation on rank ``fail_rank`` raising."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from repro_torch.launch import train as train_mod
    from repro_torch.train import step as tstep
    real, calls = tstep.loss_and_grads, []

    def flaky(*a, **kw):
        calls.append(1)
        if rank == fail_rank and len(calls) == fail_call:
            raise RuntimeError("injected failure in the backward")
        return real(*a, **kw)

    tstep.loss_and_grads = flaky
    train_mod.main(argv)


def _dmesh(shape, axes):
    from repro_torch.launch import mesh as tmesh
    return tmesh.device_mesh(tmesh.make_mesh(shape, axes), "cpu")


def _train_shardings(cfg, dm):
    from repro_torch.dist import sharding as shd
    from repro_torch.train import step as tstep
    return shd.tree_shardings(tstep.state_axes(cfg),
                              tstep.abstract_state(cfg), dm, shd.TRAIN_RULES)


def train_step(cfg, state, i, act=None):
    """Step ``i`` of the sharded-step problem (``act``: the act_ctx)."""
    import contextlib

    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.train import step as tstep
    ts = tstep.make_train_step(cfg, accum=ACCUM, peak_lr=LR,
                               xent_chunk=XENT_CHUNK)
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH), i, model_cfg=cfg)
    with act or contextlib.nullcontext():
        return ts(state, batch)


def sharded_step_and_save(rank: int, out: str):
    """(a) init_state(cfg, 0) written (the reference starts from it), then
    the 2x4 sharded step for STEPS steps, the state written, the losses
    and this rank's embedding shard recorded; (b) init_state(cfg, 7) of
    the reshard config written from a 4x2 mesh."""
    from repro_torch import configs
    from repro_torch.dist import sharding as shd
    from repro_torch.train import step as tstep
    from repro_torch.train.ckpt import Checkpointer

    out = pathlib.Path(out)
    cfg = configs.get_reduced(ARCH_STEP)
    init = tstep.init_state(cfg, 0, device="cpu")
    if rank == 0:
        Checkpointer(out / "init").save(init, 0)
    dist.barrier()
    dm = _dmesh((2, 4), ("data", "model"))
    state = shd.distribute(init, _train_shardings(cfg, dm))
    losses = []
    for i in range(STEPS):
        state, met = train_step(cfg, state, i,
                                shd.act_ctx(dm, shd.TRAIN_RULES))
        losses.append(float(met["loss"]))
    Checkpointer(out / "sharded").save(state, STEPS)
    emb = state["params"]["embed"]
    rec = dict(losses=losses, local=list(emb.to_local().shape),
               whole=list(emb.shape), fallbacks=dict(shd.FALLBACKS))
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, rec)
    if rank == 0:
        (out / "sharded.json").write_text(json.dumps(gathered))

    # int8 compression of a sharded gradient: the scale is the whole
    # tensor's, so codes, dequantised values and errors are the unsharded
    # ones bit for bit
    from repro_torch.optim import compress
    gen = torch.Generator().manual_seed(5)
    g, e = (torch.randn(64, 32, generator=gen) * s for s in (1.0, 0.01))
    place = {"w": (dm, (shd.Shard(0), shd.Shard(1)))}
    got = compress.compress_grads(shd.distribute({"w": g}, place),
                                  shd.distribute({"w": e}, place))
    want = compress.compress_grads({"w": g}, {"w": e})
    for a, b in zip(got, want):
        assert torch.equal(a["w"].full_tensor(), b["w"])

    ccfg = configs.get_reduced(ARCH_CKPT)
    dm42 = _dmesh((4, 2), ("data", "model"))
    st7 = shd.distribute(tstep.init_state(ccfg, 7, device="cpu"),
                         _train_shardings(ccfg, dm42))
    Checkpointer(out / "port_4x2").save(st7, 5)


def restore_2x2_and_gpipe(rank: int, out: str):
    """(b) the port's and the reference's 4x2 checkpoints restored onto a
    2x2 mesh, each leaf gathered and held bit for bit against what was
    saved; (c) gpipe over the four ranks against sequential application,
    the result written."""
    from repro_torch import configs
    from repro_torch.dist import pipeline
    from repro_torch.dist import sharding as shd
    from repro_torch.models import common as cm
    from repro_torch.train import step as tstep
    from repro_torch.train.ckpt import Checkpointer

    out = pathlib.Path(out)
    cfg = configs.get_reduced(ARCH_CKPT)
    dm = _dmesh((2, 2), ("data", "model"))
    sh = _train_shardings(cfg, dm)
    target = tstep.init_state(cfg, 7, device="meta")
    want = tstep.init_state(cfg, 7, device="cpu")
    state, step = Checkpointer(out / "port_4x2").restore(target, shardings=sh)
    assert step == 5
    flat_sh = shd.flat_specs(sh)
    wants = dict(cm.leaves(want))
    sharded = 0
    for path, t in cm.leaves(state):
        assert tuple(t.placements) == tuple(flat_sh[path][1]), path
        assert torch.equal(t.full_tensor(), wants[path]), path
        sharded += t.to_local().numel() < t.numel()
    assert sharded > 0

    ref_ck = Checkpointer(out / "ref_4x2")
    ref, step = ref_ck.restore(target, shardings=sh)
    assert step == 5
    with np.load(out / "ref_4x2" / "step_00000005.npz") as zf:
        for path, t in cm.leaves(ref):
            got = t.full_tensor().numpy()
            np.testing.assert_array_equal(got, zf["/".join(path)])

    pipe = np.load(out / "pipe_inputs.npz")
    run = pipeline.gpipe(lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
                         _dmesh((S,), ("stage",)), "stage", S)
    got = run({"w": torch.from_numpy(pipe["w"]),
               "b": torch.from_numpy(pipe["b"])},
              torch.from_numpy(pipe["xs"]))
    seq = pipe["xs"]
    for s in range(S):
        seq = np.tanh(seq @ pipe["w"][s] + pipe["b"][s])
    np.testing.assert_allclose(got.numpy(), seq, rtol=2e-5, atol=2e-5)
    if rank == 0:
        np.save(out / "pipe_port.npy", got.numpy())
