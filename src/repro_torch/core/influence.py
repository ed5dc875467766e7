"""Influence groups (paper §3.2.2) as connected components by min-label
propagation (port of ``repro.core.influence``).

The fixpoint loop runs on the host: each round is one scatter-min on the
device over every lane and one read of "did any lane's label change".  A
lane whose labels have settled is a fixed point of the round, so the
rounds that other lanes still need leave it bit for bit.
"""
from __future__ import annotations

import torch

from .arrays import segment_sum

_BIG = 2 ** 30


def influence_labels(provider, consumer, live, num_spreaders: int, *,
                     max_rounds: int = 0) -> torch.Tensor:
    """i32[B, S] group labels (min spreader index in the component) of the
    flows ``provider`` / ``consumer`` / ``live`` [B, F]."""
    S = num_spreaders
    if max_rounds <= 0:
        max_rounds = S
    B = provider.shape[0]
    dev = provider.device
    label = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    prov = torch.where(live, provider, 0).long()
    cons = torch.where(live, consumer, 0).long()
    ends = torch.cat([prov, cons], dim=1)
    for _ in range(max_rounds):
        edge = torch.minimum(label.gather(1, prov), label.gather(1, cons))
        edge = torch.where(live, edge, _BIG)
        new = label.scatter_reduce(1, ends, torch.cat([edge, edge], dim=1),
                                   "amin", include_self=True)
        changed = bool((new != label).any())
        label = new
        if not changed:
            break
    return label


def group_sizes(labels: torch.Tensor) -> torch.Tensor:
    """i32 size of the group each spreader belongs to (``|G(s,t)|`` of the
    VM power attribution, Eq. 6), of labels [S] or of each lane of [B, S]."""
    one = labels.dim() == 1
    lab = labels[None] if one else labels
    counts = segment_sum(torch.ones_like(lab), lab, lab.shape[-1])
    out = counts.gather(1, lab.long())
    return out[0] if one else out


def same_group(labels: torch.Tensor, a, b) -> torch.Tensor:
    """Whether spreaders ``a`` and ``b`` (ints or index tensors) share an
    influence group."""
    return labels[..., a] == labels[..., b]


def coupled_vm_counts(labels, host_cpu, vm_spreader, vm_host, n_pm: int):
    """Eq. 6 group membership: ``(in_group bool[B, V], vms_on_host
    i32[B, P])``."""
    in_group = (labels.gather(1, host_cpu.long())
                == labels.gather(1, vm_spreader.long()))
    vms_on_host = segment_sum(in_group.to(torch.int32), vm_host, n_pm)
    return in_group, vms_on_host
