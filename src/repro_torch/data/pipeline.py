"""Deterministic synthetic data (port of ``repro.data.pipeline``): the LM
token batches and the streamed workload windows.

Both are drawn with numpy from the same counter-keyed Philox streams as the
reference's, so every batch and every window is bit-equal to the
reference's.  A batch is a pure function of ``(seed, step, host)``:

* **resumable**: restart at step k reproduces batch k exactly (the loader
  state is the step counter, checkpointed for free);
* **host-shardable**: each host makes only its slice of the global batch;
* **arch-aware**: it emits the extra inputs of a family (VLM patch
  embeddings with a zero-masked prefix, enc-dec frame embeddings) as
  pseudo-features.

The LM objective is next-token prediction over a Zipf-like stream with a
planted bigram, so the training loss measurably decreases.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from ..configs.shapes import VLM_PATCHES
from ..core.engine import Trace
from ..core.trace import GWA_FAMILIES


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    planted_period: int = 4     # every nth token is predictable from t-1


def _rng_for(cfg: DataConfig, step: int, host: int) -> np.random.Generator:
    key = (cfg.seed & 0xFFFFFFFF) << 96 | (step & 0xFFFFFFFF) << 64 \
        | (host & 0xFFFFFFFF) << 32 | 0xD15C
    return np.random.Generator(np.random.Philox(key=key % (1 << 128)))


def _zipf_tokens(rng, shape, vocab, a):
    # inverse-CDF zipf truncated to vocab (dense, vectorised)
    u = rng.random(shape)
    ranks = np.exp(u * np.log(vocab))  # log-uniform ~ zipf-ish tail
    return np.minimum(ranks.astype(np.int64), vocab - 1).astype(np.int32)


def make_batch(cfg: DataConfig, step: int, *, host: int = 0,
               n_hosts: int = 1, model_cfg=None) -> dict[str, np.ndarray]:
    """Host-local slice of global batch ``step``, as numpy arrays:
    ``tokens``, ``targets``, ``loss_mask`` and, for a VLM, ``patches``
    [b, P, d] before ``T - P`` text tokens (the prefix masked out of the
    loss), for an enc-dec, ``frames`` [b, T, d]."""
    if cfg.global_batch % n_hosts:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"over {n_hosts} hosts")
    b = cfg.global_batch // n_hosts
    rng = _rng_for(cfg, step, host)
    T = cfg.seq_len

    fam = getattr(model_cfg, "family", "dense") if model_cfg else "dense"
    d_model = getattr(model_cfg, "d_model", 0)

    if fam == "vlm":
        P = min(VLM_PATCHES, max(T // 4, 1))
        text_len = T - P
        toks = _zipf_tokens(rng, (b, text_len), cfg.vocab, cfg.zipf_a)
        _plant(toks, cfg)
        patches = rng.standard_normal((b, P, d_model)).astype(np.float32)
        targets = np.concatenate(
            [np.zeros((b, P), np.int32),
             np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)], axis=1)
        mask = np.concatenate(
            [np.zeros((b, P), np.float32),
             np.ones((b, text_len), np.float32)], axis=1)
        mask[:, -1] = 0.0
        return {"tokens": toks, "patches": patches, "targets": targets,
                "loss_mask": mask}

    toks = _zipf_tokens(rng, (b, T), cfg.vocab, cfg.zipf_a)
    _plant(toks, cfg)
    targets = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
    mask = np.ones((b, T), np.float32)
    mask[:, -1] = 0.0
    batch = {"tokens": toks, "targets": targets.astype(np.int32),
             "loss_mask": mask}
    if fam == "encdec":
        batch["frames"] = rng.standard_normal((b, T, d_model)).astype(
            np.float32)
    return batch


def _plant(toks: np.ndarray, cfg: DataConfig) -> None:
    """Plant a learnable bigram: token at planted positions = f(prev)."""
    p = cfg.planted_period
    idx = np.arange(toks.shape[1])
    sel = (idx % p == p - 1) & (idx > 0)
    toks[:, sel] = (toks[:, np.roll(idx, 1)[sel]] * 31 + 7) % cfg.vocab


class DataIterator:
    """Stateful convenience wrapper (state = step counter)."""

    def __init__(self, cfg: DataConfig, *, model_cfg=None, host: int = 0,
                 n_hosts: int = 1, start_step: int = 0):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.host = host
        self.n_hosts = n_hosts
        self.step = start_step

    def __next__(self):
        batch = make_batch(self.cfg, self.step, host=self.host,
                           n_hosts=self.n_hosts, model_cfg=self.model_cfg)
        self.step += 1
        return batch

    def __iter__(self):
        return self


def gwa_window_stream(family: str, n_tasks: int, window: int, *,
                      perf_core: float = 1.0, max_cores: int | None = None,
                      runtime_cap_s: float = 3.0e5, seed: int = 0):
    """Generator of GWA-moment-matched trace windows.

    The streaming counterpart of :func:`repro_torch.core.trace.
    gwa_like_trace`: yields fixed-shape ``[window]`` gid-carrying
    :class:`~repro_torch.core.engine.Trace` windows (CPU tensors) one at
    a time, so the full ``n_tasks`` trace is never held and a long
    workload streams through :func:`repro_torch.core.engine.
    simulate_stream` in O(window) host memory.  Window ``k``'s draws come
    from a Philox stream keyed on ``(seed, family, k)``; only the arrival
    offset (a float64 scalar) carries across windows, so arrivals are
    sorted across the stream.  The last window is padded and masked
    (``gid == -1``)."""
    fam = GWA_FAMILIES[family]
    cap_cores = float(max_cores if max_cores is not None else fam.max_cores)
    probs = np.asarray(fam.par_probs, np.float64)
    probs = probs / probs.sum()
    fam_key = zlib.crc32(family.encode()) & 0xFFFFFFFF
    W = int(window)
    if W <= 0:
        raise ValueError(f"window must be positive, got {window}")
    offset = 0.0  # float64 running arrival time, carried across windows
    for k, start in enumerate(range(0, n_tasks, W)):
        n = min(W, n_tasks - start)
        key = (seed & 0xFFFFFFFF) << 64 | fam_key << 32 | (k & 0xFFFFFFFF)
        rng = np.random.Generator(np.random.Philox(key=key))
        inter = fam.interarrival_scale * rng.weibull(
            fam.interarrival_shape, n)
        arrival = offset + np.cumsum(inter)
        offset = float(arrival[-1])
        runtime = np.minimum(
            np.exp(rng.normal(fam.runtime_logmean, fam.runtime_logstd, n)),
            runtime_cap_s)
        cores = np.minimum(
            2.0 ** rng.choice(len(probs), size=n, p=probs), cap_cores)
        pad = W - n

        def padded(x, fill, dtype):
            x = np.asarray(x, dtype)
            if pad:
                x = np.concatenate([x, np.full((pad,), fill, dtype)])
            return torch.from_numpy(x)

        yield Trace(
            arrival=padded(arrival, np.inf, np.float32),
            cores=padded(cores, 0.0, np.float32),
            work=padded(runtime * cores * perf_core, 0.0, np.float32),
            gid=padded(np.arange(start, start + n), -1, np.int32),
        )
