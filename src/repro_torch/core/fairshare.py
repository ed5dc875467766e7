"""Low-level scheduling logic of the unified resource sharing model (§3.2.3),
port of ``repro.core.fairshare``.

* :func:`equal_share_rates` — each spreader splits its capacity evenly;
* :func:`maxmin_rates` — max-min fairness by progressive filling;
* :func:`rates_for` and :func:`step_tau` — the rates of a 1-D
  :class:`~repro_torch.core.arrays.Consumptions` pool, and the paper's
  exact Eq. 1-2 tick over it, each on a lane of one.

``maxmin_rates`` is the simulation hot spot.  Below the kernel's size gate
(:func:`repro_torch.kernels.maxmin.solve_fits`) it is one
:func:`~repro_torch.kernels.maxmin.maxmin_solve` call; above it the rounds
run from the host: one :func:`~repro_torch.kernels.maxmin.fill_plan` per
call, then one :func:`~repro_torch.kernels.maxmin.fill_round` per round
(looked up at each call, so a test can count the rounds by replacing it).
The reference's ``backend`` switch has no counterpart: the tensors' device
picks the kernel (CUDA) or its plain version (CPU).

Every argument carries a leading lane axis (flows [B, C], spreaders
[B, S]); one launch serves all lanes, and each lane's rates are the single
lane's.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..kernels import maxmin as kmaxmin
from .arrays import Consumptions, live_mask, segment_sum


def _equal_share_offers(provider, consumer, live, perf):
    """Per-flow (provider-side, consumer-side) equal-split offered rates."""
    S = perf.shape[-1]
    livef = live.to(torch.float32)
    cnt_p = segment_sum(livef, provider, S, where=live)
    cnt_c = segment_sum(livef, consumer, S, where=live)
    prov, cons = provider.long(), consumer.long()
    offer_p = perf.gather(1, prov) / torch.clamp_min(cnt_p.gather(1, prov),
                                                     1.0)
    offer_c = perf.gather(1, cons) / torch.clamp_min(cnt_c.gather(1, cons),
                                                     1.0)
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
    if kmaxmin.solve_fits(provider.shape[-1], perf.shape[-1]):
        return kmaxmin.maxmin_solve(provider, consumer, p_l, live, perf,
                                    max_iters=max_iters, rel_eps=rel_eps)
    return kmaxmin.progressive_filling(provider, consumer, p_l, live, perf,
                                       kmaxmin.fill_round,
                                       max_iters=max_iters, rel_eps=rel_eps)


# Low-level sharing-scheduler registry (paper §3.2.3 pluggable logic); every
# entry takes ``fn(provider, consumer, p_l, live, perf, *, max_iters)``.
SCHEDULERS: dict[str, Callable] = {
    "equal": equal_share_rates,
    "maxmin": maxmin_rates,
}


def _one_lane(*xs):
    return tuple(x[None] for x in xs)


def rates_for(cons: Consumptions, t: torch.Tensor, perf: torch.Tensor, *,
              scheduler: str = "maxmin"
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(rates, live)`` of a 1-D pool at the instant ``t``."""
    live = live_mask(cons, t)
    r = SCHEDULERS[scheduler](*_one_lane(cons.provider, cons.consumer,
                                         cons.p_l, live, perf))
    return r[0], live


def step_tau(cons: Consumptions, t: torch.Tensor, perf: torch.Tensor, tau,
             *, scheduler: str = "maxmin") -> Consumptions:
    """One exact tick of the provider -> consumer two-pass update.

    Eq. 1 (provider side): ``p_u* = p_u + min(p_r, p(prov), p_l) * tau``,
    the provider moves work from *remaining* into the in-flight buffer.
    Eq. 2 (consumer side): the consumer drains ``min(p(cons), p_l) * tau``
    from the buffer.  As typeset, Eq. 2 would keep ``p_u + p_r`` invariant
    (no work would ever complete); this is the conservation-consistent
    reading: ``p_r`` falls by exactly what the provider moved, which also
    matches the completion criterion ``p_u = 0 and p_r = 0`` of §3.2.3.
    The offers come from :func:`maxmin_rates` (both sides offer the rate)
    or, under ``"equal"``, from the equal-split offers of each side."""
    tau = torch.as_tensor(tau, dtype=torch.float32, device=perf.device)
    live = live_mask(cons, t)
    args = _one_lane(cons.provider, cons.consumer, cons.p_l, live, perf)
    if scheduler == "maxmin":
        offer_p = offer_c = maxmin_rates(*args)[0]
    else:
        offer_p, offer_c = (x[0] for x in _equal_share_offers(
            args[0], args[1], args[3], args[4]))
    moved = torch.minimum(cons.p_r, torch.minimum(offer_p, cons.p_l) * tau)
    moved = torch.where(live, moved, 0.0)
    p_u_star = cons.p_u + moved
    drained = torch.minimum(p_u_star, torch.minimum(offer_c, cons.p_l) * tau)
    drained = torch.where(live, drained, 0.0)
    return cons._replace(p_u=p_u_star - drained, p_r=cons.p_r - moved)
