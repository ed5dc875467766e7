"""Low-level scheduling logic of the unified resource sharing model (§3.2.3),
port of ``repro.core.fairshare``.

* :func:`equal_share_rates` — each spreader splits its capacity evenly;
* :func:`maxmin_rates` — max-min fairness by progressive filling.

``maxmin_rates`` is the simulation hot spot.  Below the kernel's size gate
(:func:`repro_torch.kernels.maxmin.solve_fits`) it is one
:func:`~repro_torch.kernels.maxmin.maxmin_solve` call; above it the rounds
run from the host through :func:`~repro_torch.kernels.maxmin.fill_stats`.
The reference's ``backend`` switch has no counterpart: the tensors' device
picks the kernel (CUDA) or its plain version (CPU).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..kernels import maxmin as kmaxmin
from .arrays import segment_sum


def _equal_share_offers(provider, consumer, live, perf):
    """Per-flow (provider-side, consumer-side) equal-split offered rates."""
    S = perf.shape[0]
    livef = live.to(torch.float32)
    cnt_p = segment_sum(livef, provider, S, where=live)
    cnt_c = segment_sum(livef, consumer, S, where=live)
    prov, cons = provider.long(), consumer.long()
    offer_p = perf[prov] / torch.clamp_min(cnt_p[prov], 1.0)
    offer_c = perf[cons] / torch.clamp_min(cnt_c[cons], 1.0)
    return offer_p, offer_c


def equal_share_rates(provider, consumer, p_l, live, perf, *,
                      max_iters: int = 0):
    """rate = min(perf[prov]/n_prov, perf[cons]/n_cons, p_l)."""
    del max_iters
    offer_p, offer_c = _equal_share_offers(provider, consumer, live, perf)
    r = torch.minimum(torch.minimum(offer_p, offer_c), p_l)
    return torch.where(live, r, 0.0)


def maxmin_rates(provider, consumer, p_l, live, perf, *,
                 max_iters: int = 64, rel_eps: float = 1e-5):
    """Max-min fair rates by progressive filling (see module docstring)."""
    if kmaxmin.solve_fits(provider.shape[0], perf.shape[0]):
        return kmaxmin.maxmin_solve(provider, consumer, p_l, live, perf,
                                    max_iters=max_iters, rel_eps=rel_eps)
    return kmaxmin.progressive_filling(provider, consumer, p_l, live, perf,
                                       kmaxmin.fill_stats,
                                       max_iters=max_iters, rel_eps=rel_eps)


# Low-level sharing-scheduler registry (paper §3.2.3 pluggable logic); every
# entry takes ``fn(provider, consumer, p_l, live, perf, *, max_iters)``.
SCHEDULERS: dict[str, Callable] = {
    "equal": equal_share_rates,
    "maxmin": maxmin_rates,
}
