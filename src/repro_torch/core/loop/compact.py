"""Bucketed active-set compaction (port of ``repro.core.loop.compact``):
per-event work that follows the *active* flows, not the provisioned cloud.

A cloud for ``V`` VMs carries ``F = V + P`` flow slots and
``S = 4P + V + 2`` spreaders, but only the flows of running VMs (and at
most ``P`` hidden consumers) are active at a time.  This module gathers
the active flows (``f_active``) and the spreaders they reference into
fixed power-of-two buckets:

* ``fidx`` — the bucket's dense flow indices, ascending, so every
  compacted reduction adds the same terms in the same order as its dense
  counterpart (the dense path is the bit-identical replay target);
* ``sidx`` / ``smap`` — the touched-spreader bucket and its inverse map
  (``smap[s] == SB`` marks an untouched spreader).

The bucket size is a watermark fixed by the spec and the run's device
(:func:`compact_bucket`).  Compaction is checked, never trusted: each
pass folds ``count <= bucket`` into ``Compact.ok``; the driver
accumulates it on the device, the engine reads it in the same read as
the loop condition and replays the scenario dense when a bucket
overflowed.

The buckets are built without a host read: ``torch.nonzero`` and boolean
indexing synchronise with the host on CUDA, so an index's place in its
bucket is its rank in a cumulative sum, scattered into a fixed buffer
with a drop slot (ascending by construction).

Every lane of a batch has buckets of its own (each field [B, bucket]),
ranked along its own row, and a verdict of its own (``ok`` [B]).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..arrays import scatter_drop

def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def compact_bucket(spec, device) -> int:
    """The flow-bucket size of a run of ``spec`` on ``device``; 0 disables
    compaction.

    ``spec.compact``: ``-1`` auto, ``0`` off, ``> 0`` an explicit bucket
    (rounded up to a power of two, kept only below the dense flow count).
    The auto rule is the reference's watermark off a CUDA device: a
    bucket of ``next_pow2(4 * n_pm + 32)``, used only when that is at most
    half the dense flow count.  On a CUDA device auto runs dense: there
    the pass is bound by the host's kernel launches, and the bucket's
    build, gathers and scatters add launches without removing any, so
    the compacted pass is slower (PERF.md).  The spreader bucket has the
    same size."""
    F = spec.n_vm + spec.n_pm
    if spec.compact == 0:
        return 0
    if spec.compact > 0:
        fb = next_pow2(spec.compact)
        return fb if fb < F else 0
    if torch.device(device).type == "cuda":
        return 0
    fb = next_pow2(4 * spec.n_pm + 32)
    return fb if 2 * fb <= F else 0


class Compact(NamedTuple):
    """One pass's active-set gather (built by ``advance``; the driver folds
    its ``ok`` through ``StageCtx.compact``)."""

    fidx: torch.Tensor    # i32[B, FB] bucket -> dense flow index (F = fill)
    fvalid: torch.Tensor  # bool[B, FB] slot holds a real active flow
    sidx: torch.Tensor    # i32[B, SB] bucket -> dense spreader (S = fill)
    smap: torch.Tensor    # i32[B, S] dense spreader -> bucket slot (SB = none)
    bprov: torch.Tensor   # i32[B, FB] provider bucket slots (SB on fill slots)
    bcons: torch.Tensor   # i32[B, FB] consumer bucket slots (SB on fill slots)
    ok: torch.Tensor      # bool[B] — both buckets held every active entry


def _ascending(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=fill)[0]`` of each row of
    ``mask`` [B, n], as int32 [B, size]: the True entries' indices in
    ascending order, the first ``size`` of them, ``fill`` past the
    count."""
    B, n = mask.shape
    rank = torch.cumsum(mask.to(torch.int32), 1, dtype=torch.int32) - 1
    dest = torch.where(mask & (rank < size), rank, size)   # size = drop
    out = torch.full((B, size), fill, dtype=torch.int32, device=mask.device)
    return scatter_drop(out, dest, torch.arange(n, dtype=torch.int32,
                                                device=mask.device))


def build_compact(spec, st) -> Compact:
    """Gather the active flows and the spreaders they reference into the
    spec-static buckets."""
    FB = compact_bucket(spec, st.f_active.device)
    SB = FB
    F = spec.n_vm + spec.n_pm
    S = spec.layout.S
    dev = st.f_active.device
    B = st.f_active.shape[0]

    bm = st.f_active
    fidx = _ascending(bm, FB, F)
    fvalid = fidx < F
    fidx_c = torch.clamp_max(fidx, F - 1).long()
    prov_d = torch.where(fvalid, st.f_prov.gather(1, fidx_c), S)
    cons_d = torch.where(fvalid, st.f_cons.gather(1, fidx_c), S)

    mark = torch.zeros((B, S + 1), dtype=torch.bool, device=dev)  # S = drop
    mark = mark.scatter_(1, torch.cat([prov_d, cons_d], dim=1).long(),
                         True)[:, :S]
    sidx = _ascending(mark, SB, S)
    smap = scatter_drop(
        torch.full((B, S), SB, dtype=torch.int32, device=dev), sidx,
        torch.arange(SB, dtype=torch.int32, device=dev))

    bprov = torch.where(
        fvalid, smap.gather(1, torch.clamp_max(prov_d, S - 1).long()), SB)
    bcons = torch.where(
        fvalid, smap.gather(1, torch.clamp_max(cons_d, S - 1).long()), SB)
    ok = (bm.sum(-1) <= FB) & (mark.sum(-1) <= SB)
    return Compact(fidx=fidx, fvalid=fvalid, sidx=sidx, smap=smap,
                   bprov=bprov, bcons=bcons, ok=ok)


def gather_flows(cp: Compact, arr: torch.Tensor, fill) -> torch.Tensor:
    """``arr[fidx]`` of each lane, with the bucket's fill slots forced to
    ``fill``."""
    F = arr.shape[-1]
    out = arr.gather(1, torch.clamp_max(cp.fidx, F - 1).long())
    return torch.where(cp.fvalid, out, fill)


def scatter_flows(cp: Compact, n_flows: int, vals: torch.Tensor,
                  fill=0.0) -> torch.Tensor:
    """Dense flow vectors [B, n_flows] holding ``vals`` at the bucket's
    indices and ``fill`` everywhere else (fill slots drop)."""
    base = torch.full((vals.shape[0], n_flows), fill, dtype=vals.dtype,
                      device=vals.device)
    return scatter_drop(base, cp.fidx, vals)
