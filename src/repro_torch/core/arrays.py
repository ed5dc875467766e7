"""Consumption kind codes, the live mask, and the fixed-order scatter helpers
the dense state updates share (port of ``repro.core.arrays``)."""
from __future__ import annotations

from typing import NamedTuple

import torch

KIND_TASK = 0          # user task running in a VM (cpu provider -> vm cpu)
KIND_IMAGE_XFER = 1    # VM image transfer (repo net-out -> pm net-in)
KIND_BOOT = 2          # VM startup work (pm cpu -> vm cpu)
KIND_HIDDEN = 3        # PM power-state "hidden consumer" work (paper §3.4.2)
KIND_XFER = 4          # generic network transfer (network benchmarks)


class Consumptions(NamedTuple):
    """SoA of resource consumptions (the fields :func:`live_mask` reads)."""

    p_u: torch.Tensor
    p_r: torch.Tensor
    active: torch.Tensor
    t_release: torch.Tensor


def live_mask(cons, t: torch.Tensor) -> torch.Tensor:
    """Consumptions that currently compete for resources (Eq. 10-11)."""
    return cons.active & (t >= cons.t_release) & (cons.p_r + cons.p_u > 0.0)


def segment_sum(data: torch.Tensor, ids: torch.Tensor, n: int,
                where: torch.Tensor | None = None) -> torch.Tensor:
    """``jax.ops.segment_sum`` of each lane: ``data`` [B, M] (or [B, M, K])
    summed by ``ids`` [B, M] in ``[0, n)`` into [B, n] (or [B, n, K]).

    The lanes share one scatter: lane ``b``'s ids are offset by ``b * n``,
    so no segment mixes lanes and each lane's sums are the single lane's.
    On the CPU ``index_add_`` adds the rows of each segment in index order,
    as XLA's scatter-add does.  On CUDA ``index_add_`` adds floats with
    atomics in no fixed order; the sorted accumulate path of ``index_put_``
    is deterministic (a stable sort, then each segment's run in a fixed
    order that depends on that run alone), so two runs give the same bits,
    whatever the lane count.  Integer sums are exact in any order.

    ``where`` marks the rows that can be nonzero; the caller guarantees
    every other row is zero.  Those rows go to slots of their own past the
    lanes' segments and are dropped: a ``+0.0`` term leaves a sum of
    non-negative terms unchanged, and the sorted CUDA path walks the rows
    of one index one after another, so thousands of idle flows sharing
    index 0 would cost a long serial chain.
    """
    B, M = ids.shape
    ids = ids.long()
    if B > 1:
        ids = ids + (torch.arange(B, device=ids.device) * n)[:, None]
    n_out = B * n
    if where is not None:
        spare = n_out + torch.arange(B * M, device=ids.device).view(B, M)
        ids = torch.where(where, ids, spare)
        n_out += B * M
    rest = tuple(data.shape[2:])
    flat = data.reshape((B * M,) + rest)
    out = torch.zeros((n_out,) + rest, dtype=data.dtype, device=data.device)
    if data.is_cuda and data.is_floating_point():
        out.index_put_((ids.reshape(-1),), flat, accumulate=True)
    else:
        out.index_add_(0, ids.reshape(-1), flat)
    return out[:B * n].view((B, n) + rest)


def lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Float sum over the last axis of each lane of ``x`` ([B, N] -> [B]; a
    1-D ``x`` gives a 0-d sum).  Each lane is reduced as the 1-D vector it
    holds, so its bits do not depend on the lane count: a reduction over
    [B, N] may split the axis in another way for another B (and round
    otherwise) on CUDA."""
    if x.dim() == 1:
        return x.sum(-1)
    if x.shape[0] == 1:
        return x[0].sum(-1)[None]
    return torch.stack([row.sum(-1) for row in x])


def scatter_drop(dst: torch.Tensor, idx: torch.Tensor,
                 src) -> torch.Tensor:
    """``dst.at[idx].set(src, mode="drop")`` in each lane: ``dst`` [B, n],
    ``idx`` [B, m] in ``[0, n]``, index ``n`` (one past the end) the drop
    slot.  Returns a new tensor; ``dst`` is left untouched."""
    n = dst.shape[-1]
    buf = torch.cat([dst, dst[:, :1]], dim=1)
    if not torch.is_tensor(src):
        src = torch.full(idx.shape, src, dtype=dst.dtype, device=dst.device)
    buf.scatter_(1, idx.long(), src.to(dst.dtype).expand(idx.shape))
    return buf[:, :n]
