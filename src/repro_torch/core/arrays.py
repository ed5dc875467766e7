"""Consumption kind codes, the struct-of-arrays :class:`Consumptions` with
its slot pool (:func:`alloc_slot`, :func:`register`, :func:`deregister`),
the live mask, :class:`KahanSum`, and the fixed-order scatter helpers the
dense state updates share (port of ``repro.core.arrays``).

The slot-pool helpers work on one 1-D pool and never read a device value
on the host: the slot is an index tensor, and a write that is refused
(``enable`` False or no slot free) writes each slot's old value back."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device

KIND_TASK = 0          # user task running in a VM (cpu provider -> vm cpu)
KIND_IMAGE_XFER = 1    # VM image transfer (repo net-out -> pm net-in)
KIND_BOOT = 2          # VM startup work (pm cpu -> vm cpu)
KIND_HIDDEN = 3        # PM power-state "hidden consumer" work (paper §3.4.2)
KIND_XFER = 4          # generic network transfer (network benchmarks)

INF = float("inf")


class Consumptions(NamedTuple):
    """SoA of resource consumptions, capacity ``C``, in the reference's field
    order.  A field left out is None: :func:`live_mask` reads only ``p_u``,
    ``p_r``, ``active`` and ``t_release``."""

    p_u: torch.Tensor = None        # f32[C] under-way buffer (paper Eq. 1)
    p_r: torch.Tensor = None        # f32[C] remaining processing
    p_l: torch.Tensor = None        # f32[C] per-time-unit processing limit
    provider: torch.Tensor = None   # i32[C] spreader index
    consumer: torch.Tensor = None   # i32[C] spreader index
    active: torch.Tensor = None     # bool[C] slot in use
    t_release: torch.Tensor = None  # f32[C] latency gate (Eq. 10-11)
    kind: torch.Tensor = None       # i32[C] engine tag (KIND_*)
    ref: torch.Tensor = None        # i32[C] engine back-reference
    total: torch.Tensor = None      # f32[C] p_r at registration

    @property
    def capacity(self) -> int:
        return self.p_r.shape[0]


def empty_consumptions(capacity: int, device=None) -> Consumptions:
    """A pool of ``capacity`` free slots (``p_l`` = inf) on ``device``
    (``None``: the GPU, see :func:`repro_torch.device.resolve_device`)."""
    dev = resolve_device(device)
    z = torch.zeros((capacity,), dtype=torch.float32, device=dev)
    zi = torch.zeros((capacity,), dtype=torch.int32, device=dev)
    return Consumptions(
        p_u=z, p_r=z, p_l=z + INF, provider=zi, consumer=zi,
        active=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        t_release=z, kind=zi, ref=zi, total=z)


def alloc_slot(active: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(slot, ok)``: the first free slot as an i32 0-d tensor (0 when the
    pool is exhausted) and whether it is free."""
    free = ~active
    slot = torch.argmax(free.to(torch.uint8))
    return slot.to(torch.int32), free.gather(0, slot.reshape(1))[0]


def register(cons: Consumptions, *, provider, consumer, amount, limit=INF,
             t_release=0.0, kind=KIND_TASK, ref=0, enable=True
             ) -> tuple[Consumptions, torch.Tensor, torch.Tensor]:
    """Register a new resource consumption in the first free slot; returns
    ``(cons, slot, ok)``.  When ``enable`` is False or no slot is free the
    pool is left as it was and ``ok`` is False (Fig. 3, step 2)."""
    slot, free_ok = alloc_slot(cons.active)
    dev = cons.active.device
    ok = free_ok & torch.as_tensor(enable, dtype=torch.bool, device=dev)
    idx = slot.long().reshape(1)
    amount = torch.as_tensor(amount, dtype=torch.float32, device=dev)

    def wr(arr, val):
        val = torch.as_tensor(val, dtype=arr.dtype, device=dev)
        return arr.scatter(0, idx, torch.where(ok, val, arr.gather(0, idx)))

    new = Consumptions(
        p_u=wr(cons.p_u, 0.0), p_r=wr(cons.p_r, amount),
        p_l=wr(cons.p_l, limit), provider=wr(cons.provider, provider),
        consumer=wr(cons.consumer, consumer), active=wr(cons.active, True),
        t_release=wr(cons.t_release, t_release), kind=wr(cons.kind, kind),
        ref=wr(cons.ref, ref), total=wr(cons.total, amount))
    return new, slot, ok


def deregister(cons: Consumptions, mask: torch.Tensor) -> Consumptions:
    """Deactivate every slot in ``mask`` (completion, Fig. 3 steps 12-13)."""
    return cons._replace(active=cons.active & ~mask)


def live_mask(cons, t: torch.Tensor) -> torch.Tensor:
    """Consumptions that currently compete for resources (Eq. 10-11)."""
    return cons.active & (t >= cons.t_release) & (cons.p_r + cons.p_u > 0.0)


class KahanSum(NamedTuple):
    """f32 compensated accumulator (``hi`` the sum, ``lo`` the
    compensation)."""

    hi: torch.Tensor
    lo: torch.Tensor

    @staticmethod
    def zero(shape=(), dtype=torch.float32, device=None) -> "KahanSum":
        z = torch.zeros(shape, dtype=dtype, device=resolve_device(device))
        return KahanSum(z, z)

    def add(self, x: torch.Tensor) -> "KahanSum":
        y = x - self.lo
        hi = self.hi + y
        return KahanSum(hi, (hi - self.hi) - y)

    @property
    def value(self) -> torch.Tensor:
        return self.hi


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
