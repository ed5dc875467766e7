"""Influence groups (paper §3.2.2) as connected components by min-label
propagation (port of ``repro.core.influence``).

The fixpoint loop runs on the host: each round is one scatter-min on the
device and one read of "did any label change".
"""
from __future__ import annotations

import torch

from .arrays import segment_sum

_BIG = 2 ** 30


def influence_labels(provider, consumer, live, num_spreaders: int, *,
                     max_rounds: int = 0) -> torch.Tensor:
    """i32[S] group labels (min spreader index in the component)."""
    S = num_spreaders
    if max_rounds <= 0:
        max_rounds = S
    dev = provider.device
    label = torch.arange(S, dtype=torch.int32, device=dev)
    prov = torch.where(live, provider, 0).long()
    cons = torch.where(live, consumer, 0).long()
    ends = torch.cat([prov, cons])
    for _ in range(max_rounds):
        edge = torch.minimum(label[prov], label[cons])
        edge = torch.where(live, edge, _BIG)
        new = label.scatter_reduce(0, ends, torch.cat([edge, edge]), "amin",
                                   include_self=True)
        changed = bool((new != label).any())
        label = new
        if not changed:
            break
    return label


def coupled_vm_counts(labels, host_cpu, vm_spreader, vm_host, n_pm: int):
    """Eq. 6 group membership: ``(in_group bool[V], vms_on_host i32[P])``."""
    in_group = labels[host_cpu.long()] == labels[vm_spreader.long()]
    vms_on_host = segment_sum(in_group.to(torch.int32), vm_host, n_pm)
    return in_group, vms_on_host
