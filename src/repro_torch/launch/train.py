"""Fault-tolerant training driver on one device (port of
``repro/launch/train.py``).

``python -m repro_torch.launch.train --arch granite-3-2b --reduced --steps 50``

Runs on the GPU unless ``--device cpu`` is given (and raises without a
card).  The reference's ``--mesh`` is not ported: the port trains on one
device, with no mesh and no sharding.  What it keeps:

* **Checkpoint/restart** — async atomic checkpoints every ``--ckpt-every``
  steps; ``--resume`` restores the latest (the data position restores for
  free: the loader is keyed by the step counter).  ``--fail-at`` exits
  with code 42 after that step, as an injected crash.
* **Straggler count** — per-step wall times feed a rolling median; steps
  slower than ``--straggler-factor`` x median are logged and counted.
* **Step retry** — a step that raises in its forward or backward is
  retried from the in-memory state up to ``--retries`` times (the state is
  as it was); one that raises while it writes the state
  (``train.step.PartialUpdateError``) is not retried, and the run stops:
  ``--resume`` goes on from the last checkpoint.
* **Gradient compression** — ``--compress`` enables int8 error-feedback
  compression of the gradients.
"""
from __future__ import annotations

import argparse
import statistics
import time

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.device import match_xla_matmul_on, resolve_device
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.train import step as step_mod
from repro_torch.train.ckpt import Checkpointer


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

    dev = resolve_device(args.device)
    match_xla_matmul_on(dev)
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get(args.arch))
    print(f"device={dev} arch={cfg.name} "
          f"params~{cm.count_params(lm.lm_spec(cfg)) / 1e6:.2f}M")

    train_step = step_mod.make_train_step(
        cfg, accum=args.accum, peak_lr=args.lr, warmup_steps=args.warmup,
        total_steps=args.steps, use_compression=args.compress,
        xent_chunk=args.xent_chunk)
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None

    start_step = 0
    if args.resume and ckpt and ckpt.latest_step() is not None:
        target = step_mod.init_state(cfg, args.seed,
                                     use_compression=args.compress,
                                     device="meta")
        state, start_step = ckpt.restore(target, device=dev)
        print(f"resumed from step {start_step}")
    else:
        state = step_mod.init_state(cfg, args.seed,
                                    use_compression=args.compress,
                                    device=dev)

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)
    times: list[float] = []
    stragglers = 0
    loss = float("nan")     # stays so when a resume finds no step to run
    for step in range(start_step, args.steps):
        batch = make_batch(dcfg, step, model_cfg=cfg)
        for attempt in range(args.retries + 1):
            try:
                t0 = time.time()
                state, metrics = train_step(state, batch)
                loss = float(metrics["loss"])     # waits for the step
                dt = time.time() - t0
                break
            except step_mod.PartialUpdateError:
                if ckpt:                # the state is partly written
                    ckpt.wait()
                raise
            except Exception as e:  # retry path (flaky step)
                if attempt == args.retries:
                    raise
                print(f"step {step} attempt {attempt} failed: {e}; retrying")
        times.append(dt)
        if len(times) > 5:
            med = statistics.median(times[-50:])
            if dt > args.straggler_factor * med:
                stragglers += 1
                print(f"step {step}: straggler ({dt:.3f}s vs median "
                      f"{med:.3f}s)")
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step} loss={loss:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.2f} {dt:.3f}s")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(state, step + 1)
        if args.fail_at and step + 1 == args.fail_at:
            if ckpt:
                ckpt.wait()
            print(f"INJECTED FAILURE at step {step + 1}")
            return 42
    if ckpt:
        ckpt.save(state, args.steps)
        ckpt.wait()
    print(f"done: {args.steps} steps, {stragglers} stragglers, "
          f"final loss {loss:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
