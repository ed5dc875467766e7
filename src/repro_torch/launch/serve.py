"""Serving launcher: bring up a batched ServeEngine for an --arch (port of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b \
        --requests 8 --batch 4 --max-new 16

``--arch`` takes any of the ten architectures of ``configs.ARCHS``; the
enc-dec one (seamless) is refused by ``ServeEngine``, whose requests carry
no source frames (the reference fails on it too).  Runs on the GPU unless
``--device cpu`` is given.  Reduced configs by default, ``--full`` for the
published widths.  Weights are random from ``--seed``, or with
``--ckpt-dir`` the parameters of the newest checkpoint there (a train
state of ``repro_torch.launch.train`` or of the reference's), each leaf
cast to its serving storage dtype (``common.storage_dtype``).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import configs
from repro_torch.device import match_xla_matmul, resolve_device
from repro_torch.models import lm
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train.ckpt import Checkpointer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCHS))
    ap.add_argument("--full", action="store_true",
                    help="full config (default: reduced)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain PyTorch path (default: GPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    match_xla_matmul()
    cfg = (configs.get(args.arch) if args.full
           else configs.get_reduced(args.arch))
    if args.ckpt_dir:
        # the serving tree's shapes and storage dtypes, filled from the file
        target = {"params": lm.init_params(cfg, args.seed, device="meta")}
        state, step = Checkpointer(args.ckpt_dir).restore(target, device=dev)
        params = state["params"]
        print(f"restored params from step {step}")
    else:
        params = lm.init_params(cfg, args.seed, device=dev)
    eng = ServeEngine(cfg, params, batch_size=args.batch,
                      max_len=args.max_len, eos_id=-1,
                      temperature=args.temperature, seed=args.seed,
                      device=dev)
    rng = np.random.RandomState(args.seed + 1)
    for rid in range(args.requests):
        plen = int(rng.randint(2, 10))
        prompt = [int(t) for t in rng.randint(2, cfg.vocab, plen)]
        eng.submit(Request(rid=rid, prompt=prompt,
                           max_new_tokens=args.max_new))
    stats = eng.run()
    print(f"{stats['requests']} requests | {stats['tokens']} tokens | "
          f"{stats['tokens_per_s']:.1f} tok/s | "
          f"p50 {stats['p50_latency_s']:.2f}s p99 "
          f"{stats['p99_latency_s']:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
