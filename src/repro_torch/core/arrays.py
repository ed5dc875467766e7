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
    """``jax.ops.segment_sum`` over the leading axis.

    On the CPU ``index_add_`` adds the rows of each segment in index order,
    as XLA's scatter-add does.  On CUDA ``index_add_`` adds floats with
    atomics in no fixed order; the sorted accumulate path of ``index_put_``
    is deterministic, so two runs give the same bits.  Integer sums are
    exact in any order.

    ``where`` marks the rows that can be nonzero; the caller guarantees
    every other row is zero.  Those rows go to slots of their own past
    ``n`` and are dropped: a ``+0.0`` term leaves a sum of non-negative
    terms unchanged, and the sorted CUDA path walks the rows of one index
    one after another, so thousands of idle flows sharing index 0 would
    cost a long serial chain.
    """
    ids = ids.long()
    n_out = n
    if where is not None:
        spare = n + torch.arange(ids.shape[0], device=ids.device)
        ids = torch.where(where, ids, spare)
        n_out = n + ids.shape[0]
    out = torch.zeros((n_out,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    if data.is_cuda and data.is_floating_point():
        out.index_put_((ids,), data, accumulate=True)
    else:
        out.index_add_(0, ids, data)
    return out[:n]


def scatter_drop(dst: torch.Tensor, idx: torch.Tensor,
                 src) -> torch.Tensor:
    """``dst.at[idx].set(src, mode="drop")`` for indices in ``[0, n]``:
    index ``n`` (one past the end) is the drop slot.  Returns a new tensor;
    ``dst`` is left untouched."""
    n = dst.shape[0]
    buf = torch.cat([dst, dst[:1]])
    if not torch.is_tensor(src):
        src = torch.full(idx.shape, src, dtype=dst.dtype, device=dst.device)
    buf.scatter_(0, idx.long(), src.to(dst.dtype))
    return buf[:n]
