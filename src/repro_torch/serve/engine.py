"""Batched serving engine: request queue -> prefill -> decode loop (port of
``repro/serve/engine.py``).

Static batching with padded prompts: the engine drains its queue in batches
of ``batch_size``, runs :func:`repro_torch.models.lm.prefill` over the
prompts, left-padded with token 0 so that every prompt's last token sits at
the same cache index, then steps :func:`repro_torch.models.lm.decode_step`
until every sequence emits ``eos_id`` or reaches its ``max_new_tokens``.
Sampling is greedy (``argmax``, the first maximum) or, with
``temperature > 0``, categorical from the engine's own ``torch.Generator``;
those samples are not bit-equal to ``jax.random.categorical``'s.

The engine serves token prompts, for every family but enc-dec: an enc-dec
prompt needs its source ``frames``, which a :class:`Request` does not carry
(the reference's engine fails on its first prefill with a ``KeyError``);
this one refuses such a config when it is made.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 32
    submitted_s: float = 0.0
    completed_s: float = 0.0
    output: list[int] = dataclasses.field(default_factory=list)


class ServeEngine:
    """Serves on ``device`` (the GPU unless the caller passes ``"cpu"``);
    ``params`` must lie there."""

    def __init__(self, cfg, params, *, batch_size: int = 8,
                 max_len: int = 256, eos_id: int = 1,
                 temperature: float = 0.0, seed: int = 0, device=None):
        if cfg.is_encdec:
            raise ValueError(
                f"ServeEngine: {cfg.name} is an encoder-decoder config, whose "
                f"prompts need their source frames; serve it with "
                f"lm.prefill(cfg, params, {{'tokens': ..., 'frames': ...}}, "
                f"lm.init_cache(cfg, B, max_len, enc_len=S)) and "
                f"lm.decode_step")
        self.device = resolve_device(device)
        got = params["embed"].device
        if got.type != self.device.type:
            raise ValueError(f"ServeEngine: parameters lie on {got}, the "
                             f"engine serves on {self.device}")
        self.cfg = cfg
        self.params = params
        self.batch = batch_size
        self.max_len = max_len
        self.eos = eos_id
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.queue: list[Request] = []
        self.done: list[Request] = []
        self._prefill = lambda p, b, c: lm.prefill(cfg, p, b, c)
        self._decode = lambda p, t, c: lm.decode_step(cfg, p, t, c)

    def submit(self, req: Request) -> None:
        req.submitted_s = time.time()
        self.queue.append(req)

    # ------------------------------------------------------------------
    def _sample(self, logits) -> torch.Tensor:
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]

    def run_batch(self) -> list[Request]:
        """Serve up to ``batch_size`` queued requests to completion."""
        reqs = self.queue[:self.batch]
        self.queue = self.queue[len(reqs):]
        if not reqs:
            return []
        B = len(reqs)
        plen = max(len(r.prompt) for r in reqs)
        toks = np.zeros((B, plen), np.int64)
        for i, r in enumerate(reqs):  # left-pad
            toks[i, plen - len(r.prompt):] = r.prompt
        cache = lm.init_cache(self.cfg, B, self.max_len, device=self.device)
        logits, cache = self._prefill(
            self.params, {"tokens": torch.from_numpy(toks).to(self.device)},
            cache)
        live = np.ones((B,), bool)
        max_new = max(r.max_new_tokens for r in reqs)
        cur = self._sample(logits)
        for r, t in zip(reqs, cur.cpu().numpy()):
            r.output.append(int(t))
        for _ in range(max_new - 1):
            logits, cache = self._decode(self.params, cur[:, None], cache)
            cur = self._sample(logits)
            arr = cur.cpu().numpy()
            for i, r in enumerate(reqs):
                if not live[i]:
                    continue
                tok = int(arr[i])
                r.output.append(tok)
                if tok == self.eos or len(r.output) >= r.max_new_tokens:
                    live[i] = False
            if not live.any():
                break
        now = time.time()
        for r in reqs:
            r.completed_s = now
            self.done.append(r)
        return reqs

    def run(self) -> dict:
        """Drain the queue; return throughput/latency stats."""
        t0 = time.time()
        n_tokens = 0
        while self.queue:
            batch = self.run_batch()
            n_tokens += sum(len(r.output) for r in batch)
        wall = time.time() - t0
        lats = [r.completed_s - r.submitted_s for r in self.done]
        return {
            "requests": len(self.done),
            "tokens": n_tokens,
            "wall_s": wall,
            "tokens_per_s": n_tokens / max(wall, 1e-9),
            "p50_latency_s": float(np.percentile(lats, 50)) if lats else 0.0,
            "p99_latency_s": float(np.percentile(lats, 99)) if lats else 0.0,
        }
