"""Networking model (paper §3.4.1): a network node is an ``<in, out>``
spreader pair (port of ``repro.core.network``).

A node owns an incoming and an outgoing spreader whose processing power is
its bandwidth; a transfer is a resource consumption from the source's
*out* spreader to the target's *in* spreader, latency-gated by
``t_release = t_register + latency`` (Eqs. 7-11, the ``s_nil``
construction).  Intermediary entities (routers) act by capping the
transfer's ``p_l``.

These helpers build :class:`repro_torch.core.sharing.SharingProblem`
instances for pure-network scenarios (the Fig. 9 validation and the
network cells of ``chip_smoke.py``); the cloud engine uses the same
indexing convention for the PM and repository NICs.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..device import resolve_device
from .sharing import SharingProblem


class NetworkTopology(NamedTuple):
    """n nodes; spreader layout: node i -> out = 2*i, in = 2*i + 1."""

    in_bw: torch.Tensor    # f32[n]  MB/s
    out_bw: torch.Tensor   # f32[n]  MB/s
    latency: torch.Tensor  # f32[n, n] seconds

    @property
    def num_nodes(self) -> int:
        return self.in_bw.shape[0]

    def out_idx(self, i):
        return 2 * i

    def in_idx(self, i):
        return 2 * i + 1

    def spreader_perf(self) -> torch.Tensor:
        """f32[2n]: the out bandwidths at even, the in bandwidths at odd
        spreader indices."""
        return torch.stack([self.out_bw, self.in_bw], dim=1).reshape(-1)


def make_topology(in_bw: Sequence[float], out_bw: Sequence[float],
                  latency: float | Sequence[Sequence[float]] = 0.0, *,
                  device=None) -> NetworkTopology:
    """A topology on ``device`` (``None``: the GPU, raising without one;
    ``"cpu"`` the plain path); a scalar ``latency`` holds for every pair."""
    dev = resolve_device(device)
    in_bw = torch.as_tensor(in_bw, dtype=torch.float32, device=dev)
    out_bw = torch.as_tensor(out_bw, dtype=torch.float32, device=dev)
    n = in_bw.shape[0]
    lat = torch.as_tensor(latency, dtype=torch.float32, device=dev)
    if lat.dim() == 0:
        lat = lat.expand(n, n).clone()
    return NetworkTopology(in_bw=in_bw, out_bw=out_bw, latency=lat)


def transfers_problem(topo: NetworkTopology, src: Sequence[int],
                      dst: Sequence[int], size_mb: Sequence[float], *,
                      t_register: Sequence[float] | None = None,
                      route_cap: Sequence[float] | None = None
                      ) -> SharingProblem:
    """The sharing problem of point-to-point transfers, on the topology's
    device.  ``route_cap`` models intermediary routers by capping each
    transfer's ``p_l`` at the narrowest link on its route."""
    dev = topo.in_bw.device
    src = torch.as_tensor(src, dtype=torch.int32, device=dev)
    dst = torch.as_tensor(dst, dtype=torch.int32, device=dev)
    size = torch.as_tensor(size_mb, dtype=torch.float32, device=dev)
    C = size.shape[0]
    t_reg = (torch.zeros((C,), dtype=torch.float32, device=dev)
             if t_register is None
             else torch.as_tensor(t_register, dtype=torch.float32,
                                  device=dev))
    t_start = t_reg + topo.latency[src.long(), dst.long()]
    return SharingProblem.build(
        perf=topo.spreader_perf(),
        provider=2 * src,          # source out-spreader
        consumer=2 * dst + 1,      # target in-spreader
        amount=size, limit=route_cap, t_start=t_start, device=dev)
