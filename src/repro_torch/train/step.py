"""Training step: chunked cross-entropy, gradient accumulation, AdamW (port
of ``repro/train/step.py``), on one device.

* **Chunked loss** — the final ``[B, T, vocab]`` logits never exist: the
  normed hidden states are unembedded a sequence chunk at a time inside
  :func:`torch.utils.checkpoint.checkpoint`, so the forward and the
  backward each hold one ``[B, chunk, vocab]`` slab.
* **Gradient accumulation** — the batch's leading axis is split into
  ``accum`` microbatches run in order; their gradients accumulate in f32.
* **Gradient compression** — an optional int8 error-feedback pass
  (:mod:`repro_torch.optim.compress`) between accumulation and AdamW.
* **f32 state** — every parameter is kept in f32 whatever the compute
  dtype (the model casts each weight at its use), with f32 moments, as
  the reference's ``init_state``.

The state is ``{"params", "opt": AdamWState(step, m, v), ["err"]}`` in the
reference's nesting.  ``train_step(state, batch)`` updates the state's
tensors in place and returns it, as the reference's launcher donates the
state to its jitted step: the update runs after the gradients, so a step
that raises in its forward or backward leaves the state as it was, and one
that raises in its compression or update raises
:class:`PartialUpdateError`, its state partly written and not to be used
again (the reference's donated state is gone in that case too).
Training runs the model's plain paths (``attn_impl="chunked"``, the
configs' default): the kernel wrappers have no backward and refuse inputs
that require grad.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils import checkpoint as ckpt

from ..device import resolve_device
from ..models import common as cm
from ..models import lm
from ..optim import adamw, compress, schedule as sched_mod

METRICS = ("loss", "tokens", "moe_lb", "moe_z", "moe_dropped")


class PartialUpdateError(RuntimeError):
    """A train step failed after it began writing the state (the error
    buffer, the parameters or the moments): the state is partly updated,
    and a retry from it would train on a mix of two steps."""


def _xent_chunk(cfg, params, hc, tc, mc):
    logits = lm.unembed(cfg, params, hc)                 # (B, c, V) f32
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, tc[..., None])[..., 0]
    return torch.sum((lse - ll) * mc), torch.sum(mc)


def chunked_xent(cfg, params, h, targets, mask, *, chunk: int = 512):
    """(sum of token cross-entropies, token count), unembedding ``chunk``
    positions at a time and summing the chunks in order in f32."""
    B, T, d = h.shape
    c = min(chunk, T)
    Tp = -(-T // c) * c
    h = torch.nn.functional.pad(h, (0, 0, 0, Tp - T))
    targets = torch.nn.functional.pad(targets, (0, Tp - T))
    mask = torch.nn.functional.pad(mask, (0, Tp - T))
    body = functools.partial(_xent_chunk, cfg, params)
    if torch.is_grad_enabled():
        body = functools.partial(ckpt.checkpoint, body, use_reentrant=False)
    loss = torch.zeros((), dtype=torch.float32, device=h.device)
    denom = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, Tp, c):
        lc, nc = body(h[:, i:i + c], targets[:, i:i + c], mask[:, i:i + c])
        loss = loss + lc
        denom = denom + nc
    return loss, denom


def loss_fn(cfg, params, batch, *, lb_coef: float = 0.01,
            z_coef: float = 1e-3, xent_chunk: int = 512):
    """(total loss, metrics): ``ce + lb_coef * aux[0] + z_coef * aux[1]``
    with the reference's metrics (``loss`` is the mean cross-entropy)."""
    h, aux = lm.forward_hidden(cfg, params, batch)
    dev = h.device
    targets = torch.as_tensor(batch["targets"], dtype=torch.long, device=dev)
    mask = torch.as_tensor(batch["loss_mask"], dtype=torch.float32,
                           device=dev)
    loss, denom = chunked_xent(cfg, params, h, targets, mask,
                               chunk=xent_chunk)
    ce = loss / torch.clamp(denom, min=1.0)
    total = ce + lb_coef * aux[0] + z_coef * aux[1]
    metrics = {"loss": ce, "tokens": denom, "moe_lb": aux[0],
               "moe_z": aux[1], "moe_dropped": aux[2]}
    return total, metrics


def loss_and_grads(cfg, params, batch, **loss_kw):
    """(gradients of :func:`loss_fn` as a tree of ``params``' nesting,
    metrics detached): ``jax.grad(loss_fn, has_aux=True)`` of the
    reference.  A leaf the loss does not reach gets zeros."""
    pairs = cm.leaves(params)
    with torch.enable_grad():
        leaves = {path: t.detach().requires_grad_(True) for path, t in pairs}
        total, metrics = loss_fn(
            cfg, cm.tree_map(lambda path, _: leaves[path], params), batch,
            **loss_kw)
        grads = torch.autograd.grad(total, list(leaves.values()),
                                    allow_unused=True)
    grads = {path: torch.zeros_like(t) if g is None else g
             for (path, t), g in zip(pairs, grads)}
    return (cm.tree_map(lambda path, _: grads[path], params),
            {k: v.detach() for k, v in metrics.items()})


def init_state(cfg, seed: int, *, use_compression: bool = False,
               device=None) -> dict:
    """The train state of ``cfg`` from ``seed`` on ``device`` (the GPU by
    default; ``"meta"`` gives shapes and dtypes only, a restore target):
    every parameter leaf in f32, whatever ``common.storage_dtype`` says."""
    dev = resolve_device(device)
    params = cm.materialize(lm.lm_spec(cfg), cm.seeded_generator(seed, dev),
                            device=dev, compute_dtype="float32")
    state = {"params": params, "opt": adamw.init(params)}
    if use_compression:
        state["err"] = compress.init_error(params)
    return state


def abstract_state(cfg, *, use_compression: bool = False) -> dict:
    """The train state as ``meta`` tensors (the dry run: no storage), in
    the reference's dtypes: f32 parameters, moments and error buffer, an
    int32 step."""
    return init_state(cfg, 0, use_compression=use_compression,
                      device="meta")


def state_axes(cfg, *, use_compression: bool = False) -> dict:
    """Logical axes for every train-state leaf (mirrors abstract_state)."""
    axes = cm.logical_axes(lm.lm_spec(cfg))
    state = {"params": axes, "opt": adamw.AdamWState((), axes, axes)}
    if use_compression:
        state["err"] = axes
    return state


def make_train_step(cfg, *, accum: int = 1, peak_lr: float = 3e-4,
                    warmup_steps: int = 100, total_steps: int = 10_000,
                    weight_decay: float = 0.1, max_grad_norm: float = 1.0,
                    schedule: str = "warmup_cosine",
                    use_compression: bool = False,
                    lb_coef: float = 0.01, z_coef: float = 1e-3,
                    xent_chunk: int = 512) -> Callable:
    """Build ``train_step(state, batch) -> (state, metrics)``: the state is
    updated in place, and a failure while it is written raises
    :class:`PartialUpdateError` (module docstring); ``batch`` holds arrays or tensors
    with the global batch on the leading axis.  The metrics are 0-d
    tensors: the reference's ``loss``, ``tokens``, ``moe_lb``, ``moe_z``,
    ``moe_dropped``, ``lr``, ``grad_norm`` and ``step``."""
    sched = functools.partial(sched_mod.SCHEDULES[schedule],
                              peak_lr=peak_lr, warmup_steps=warmup_steps,
                              total_steps=total_steps)
    grads_of = functools.partial(loss_and_grads, cfg, lb_coef=lb_coef,
                                 z_coef=z_coef, xent_chunk=xent_chunk)

    def train_step(state, batch):
        params = state["params"]
        if accum == 1:
            grads, metrics = grads_of(params, batch)
        else:
            n = len(next(iter(batch.values())))
            if n % accum:
                raise ValueError(f"batch of {n} does not split into "
                                 f"{accum} microbatches")
            size = n // accum
            grads = cm.tree_map(
                lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
            metrics = {k: 0.0 for k in METRICS}
            for i in range(accum):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                g, met = grads_of(params, mb)
                g = dict(cm.leaves(g))
                grads = cm.tree_map(lambda path, a: a + g[path].float(),
                                    grads)
                metrics = {k: metrics[k] + met[k] for k in METRICS}
            grads = cm.tree_map(lambda _, g: g / accum, grads)
            metrics = {k: v / accum for k, v in metrics.items()}

        lr = sched(state["opt"].step + 1)
        try:
            if use_compression:
                grads, state["err"] = compress.compress_grads(grads,
                                                              state["err"])
            state["params"], state["opt"], opt_metrics = adamw.update(
                grads, state["opt"], params, lr=lr,
                weight_decay=weight_decay, max_grad_norm=max_grad_norm)
        except Exception as e:
            raise PartialUpdateError(
                f"train step failed while writing the state: {e}") from e
        metrics = dict(metrics, lr=lr, **opt_metrics,
                       step=state["opt"].step.float())
        return state, metrics

    return train_step

