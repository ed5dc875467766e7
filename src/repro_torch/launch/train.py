"""Fault-tolerant, elastic training driver (port of
``repro/launch/train.py``).

``python -m repro_torch.launch.train --arch granite-3-2b --reduced --steps 50``
on one device, or on a mesh of ranks:
``torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch
granite-3-2b --reduced --mesh 2x2``.

Runs on the GPU unless ``--device cpu`` is given (and raises without a
card).  Under ``torchrun`` (``WORLD_SIZE`` set) the ranks come from the
environment, NCCL on the cards and ``gloo`` with ``--device cpu``;
``--mesh AxB[xC]`` names its axes the last of ``("pod", "data",
"model")``, and without it every rank goes on the data axis.  The state
is sharded by ``dist.sharding.TRAIN_RULES`` (FSDP over ``data``, tensor
parallel over ``model``) and the step runs under ``act_ctx``
(:func:`build`).  Only rank 0 prints and writes.  Without ``torchrun`` it
trains on this one device, with no mesh.  What it keeps:

* **Checkpoint/restart** — async atomic checkpoints every ``--ckpt-every``
  steps; ``--resume`` restores the latest (the data position restores for
  free: the loader is keyed by the step counter).  ``--fail-at`` exits
  with code 42 after that step, as an injected crash.
* **Elastic re-carve** — a checkpoint of one mesh restores onto another
  (rerun with a different ``--mesh`` or rank count): each leaf is read
  and placed on the current mesh's shardings.
* **Straggler count** — per-step wall times feed a rolling median; steps
  slower than ``--straggler-factor`` x median are logged and counted.
* **Step retry** — a step that raises in its forward or backward is
  retried from the in-memory state up to ``--retries`` times (the state is
  as it was); one that raises while it writes the state
  (``train.step.PartialUpdateError``) is not retried, and the run stops:
  ``--resume`` goes on from the last checkpoint.  On a mesh of more than
  one rank a step is not retried: a failure is one rank's, the others are
  inside that step's collectives or past them, and a retry would pair its
  collectives with theirs wrongly.  The rank prints its failure and
  raises, and torchrun ends the others; ``--resume`` goes on.
* **Gradient compression** — ``--compress`` enables int8 error-feedback
  compression of the gradients.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import torch.distributed as dist

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.device import match_xla_matmul_on, resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.train import step as step_mod
from repro_torch.train.ckpt import Checkpointer


def build(cfg, mesh, args):
    """(the train step, the state's shardings, the abstract state) on the
    DeviceMesh ``mesh``: the reference's ``build``.  The step runs inside
    ``act_ctx(mesh, TRAIN_RULES)`` and updates its sharded state in place
    (``args``: ``compress``, ``accum``, ``lr``, ``warmup``, ``steps``,
    ``xent_chunk``)."""
    state_abs = step_mod.abstract_state(cfg, use_compression=args.compress)
    state_ax = step_mod.state_axes(cfg, use_compression=args.compress)
    state_sh = shd.tree_shardings(state_ax, state_abs, mesh,
                                  shd.TRAIN_RULES)
    train_step = step_mod.make_train_step(
        cfg, accum=args.accum, peak_lr=args.lr, warmup_steps=args.warmup,
        total_steps=args.steps, use_compression=args.compress,
        xent_chunk=args.xent_chunk)

    def step_in_ctx(state, batch):
        with shd.act_ctx(mesh, shd.TRAIN_RULES):
            return train_step(state, batch)

    return step_in_ctx, state_sh, state_abs


def _setup(args):
    """(device, DeviceMesh or None, rank): ranks from the environment
    under ``torchrun``, else this one device and no mesh."""
    if "WORLD_SIZE" not in os.environ:
        if args.mesh and mesh_mod.parse_mesh(args.mesh).size > 1:
            raise RuntimeError(f"--mesh {args.mesh} needs one process a "
                               f"device: run it under torchrun")
        return resolve_device(args.device), None, 0
    dev = mesh_mod.init_from_env(args.device)
    mesh = (mesh_mod.parse_mesh(args.mesh) if args.mesh else
            mesh_mod.make_mesh((dist.get_world_size(), 1),
                               ("data", "model")))
    return dev, mesh_mod.device_mesh(mesh, dev), dist.get_rank()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-size config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--mesh", default="",
                    help="e.g. '2x2' (data x model), under torchrun; "
                         "default: every rank on the data axis")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--retries", type=int, default=2)
    ap.add_argument("--straggler-factor", type=float, default=2.0)
    ap.add_argument("--fail-at", type=int, default=0,
                    help="inject a crash after this step (restart test)")
    ap.add_argument("--xent-chunk", type=int, default=512)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain PyTorch path (default: GPU)")
    args = ap.parse_args(argv)
    try:
        return _run(args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run(args) -> int:
    dev, mesh, rank = _setup(args)
    say = print if rank == 0 else (lambda *a, **k: None)
    match_xla_matmul_on(dev)
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get(args.arch))
    where = f" mesh={shd.mesh_shape(mesh)}" if mesh is not None else ""
    say(f"device={dev}{where} arch={cfg.name} "
        f"params~{cm.count_params(lm.lm_spec(cfg)) / 1e6:.2f}M")

    if mesh is None:
        train_step = step_mod.make_train_step(
            cfg, accum=args.accum, peak_lr=args.lr,
            warmup_steps=args.warmup, total_steps=args.steps,
            use_compression=args.compress, xent_chunk=args.xent_chunk)
    else:
        train_step, state_sh, _ = build(cfg, mesh, args)
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None

    start_step = 0
    if args.resume and ckpt and ckpt.latest_step() is not None:
        target = step_mod.init_state(cfg, args.seed,
                                     use_compression=args.compress,
                                     device="meta")
        if mesh is None:
            state, start_step = ckpt.restore(target, device=dev)
        else:
            state, start_step = ckpt.restore(target, shardings=state_sh)
        say(f"resumed from step {start_step}")
    else:
        state = step_mod.init_state(cfg, args.seed,
                                    use_compression=args.compress,
                                    device=dev)
        if mesh is not None:
            state = shd.distribute(state, state_sh)

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)
    times: list[float] = []
    stragglers = 0
    loss = float("nan")     # stays so when a resume finds no step to run
    alone = mesh is None or mesh.size() == 1
    retries = args.retries if alone else 0
    for step in range(start_step, args.steps):
        batch = make_batch(dcfg, step, model_cfg=cfg)
        for attempt in range(retries + 1):
            try:
                t0 = time.time()
                state, metrics = train_step(state, batch)
                loss = float(metrics["loss"])     # waits for the step
                dt = time.time() - t0
                break
            except Exception as e:
                partial = isinstance(e, step_mod.PartialUpdateError)
                if partial or attempt == retries:
                    print(f"rank {rank}: step {step} failed: {e}",
                          file=sys.stderr, flush=True)
                    if partial and ckpt:    # the state is partly written
                        ckpt.wait(barrier=alone)
                    raise
                print(f"step {step} attempt {attempt} failed: {e}; "
                      f"retrying")
        times.append(dt)
        if len(times) > 5:
            med = statistics.median(times[-50:])
            if dt > args.straggler_factor * med:
                stragglers += 1
                say(f"step {step}: straggler ({dt:.3f}s vs median "
                    f"{med:.3f}s)")
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step} loss={loss:.4f} "
                f"lr={float(metrics['lr']):.2e} "
                f"gnorm={float(metrics['grad_norm']):.2f} {dt:.3f}s")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(state, step + 1)
        if args.fail_at and step + 1 == args.fail_at:
            if ckpt:
                ckpt.wait()
            say(f"INJECTED FAILURE at step {step + 1}")
            return 42
    if ckpt:
        ckpt.save(state, args.steps)
        ckpt.wait()
    say(f"done: {args.steps} steps, {stragglers} stragglers, "
        f"final loss {loss:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
