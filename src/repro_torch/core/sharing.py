"""Bare unified-resource-sharing simulation, paper §3.2 as a standalone core
(port of ``repro.core.sharing``).

``run_sharing`` simulates a set of resource consumptions over a set of
spreaders to completion by event-horizon time jumps: rates are
piecewise-constant between events (arrivals, latency releases,
completions), so jumping to the next event and integrating exactly is
DISSECT-CF's ``Timed`` time-jump control (§3.1) without per-tau ticking.
This is the core of the CPU-sharing and networking validation figures
(Figs. 7-9) and of the pure-sharing performance figures (Fig. 12/13,
Table 3).  ``run_sharing_tau`` is the paper's exact Eq. 1-2 tick over the
same problem.

The reference's ``lax.while_loop`` is a loop on the host: each pass is one
body on 1-D tensors, and the host reads one value a pass, whether the
body found a next event (the pass count, and so ``n < max_events``, is
the host's own).  The rates are ``fairshare.SCHEDULERS[scheduler]`` on a
lane of one: below the solve's size gate one ``maxmin_solve`` launch and
no other read; above it one ``fill_plan`` and a ``fill_round`` a round,
with one read a round.  The horizon and the two segment sums are plain
torch, as they are plain reductions outside any kernel in the reference.
The reference's ``backend`` switch has no counterpart: the tensors' device
picks the kernel (CUDA) or its plain version (CPU).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from .arrays import Consumptions, empty_consumptions, segment_sum
from .fairshare import SCHEDULERS, step_tau

_BIG = 3.0e38   # f32 "no event" sentinel (rounds to the reference's f32 3e38)


def _f32(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


class SharingProblem(NamedTuple):
    """A static description of spreaders and consumptions.

    ``t_start`` doubles as arrival time and latency gate (Eq. 10-11): the
    consumption exists but does not perform before it."""

    perf: torch.Tensor       # f32[S] spreader capacity (units/s)
    provider: torch.Tensor   # i32[C]
    consumer: torch.Tensor   # i32[C]
    amount: torch.Tensor     # f32[C] total units to process
    limit: torch.Tensor      # f32[C] per-consumption rate cap (p_l)
    t_start: torch.Tensor    # f32[C]

    @staticmethod
    def build(perf, provider, consumer, amount, limit=None, t_start=None, *,
              device=None) -> "SharingProblem":
        """The problem on ``device`` (``None``: the GPU, raising without
        one; ``"cpu"`` the plain path).  ``limit`` defaults to 3e38 and
        ``t_start`` to 0."""
        dev = resolve_device(device)
        amount = _f32(amount, dev)
        C = amount.shape[0]
        return SharingProblem(
            perf=_f32(perf, dev),
            provider=torch.as_tensor(provider, dtype=torch.int32, device=dev),
            consumer=torch.as_tensor(consumer, dtype=torch.int32, device=dev),
            amount=amount,
            limit=(torch.full((C,), _BIG, dtype=torch.float32, device=dev)
                   if limit is None else _f32(limit, dev)),
            t_start=(torch.zeros((C,), dtype=torch.float32, device=dev)
                     if t_start is None else _f32(t_start, dev)))


class SharingResult(NamedTuple):
    completion: torch.Tensor  # f32[C] completion times (inf if never done)
    t_end: torch.Tensor       # f32 simulation end time
    n_events: torch.Tensor    # i32 number of horizon jumps
    ok: torch.Tensor          # bool: every consumption completed
    energy: torch.Tensor      # f32[S] per-spreader energy (J), 0 without power
    processed: torch.Tensor   # f32[S] provider-side processed units


def _drain(p_r: torch.Tensor, r: torch.Tensor, dt: torch.Tensor
           ) -> torch.Tensor:
    """``p_r - r * dt`` with the product rounded apart.  XLA:CPU contracts
    the reference's drain into one fused multiply-add, so a residue can
    differ by an ulp and a completion land one pass apart (ROADMAP queue
    3); a test swaps this for the fused form to show that this is the only
    difference."""
    return p_r - r * dt


def run_sharing(prob: SharingProblem, *, scheduler: str = "maxmin",
                max_events: int = 1_000_000, max_fill_iters: int = 64,
                p_idle=None, p_span=None) -> SharingResult:
    """Simulate to completion, or to ``max_events`` passes; with ``p_idle``
    integrate the linear power model ``P(s) = p_idle[s] + p_span[s] *
    utilisation(s)`` of each spreader.  ``n_events`` counts every pass,
    the last one (which finds no next event) included."""
    dev = prob.perf.device
    S = prob.perf.shape[0]
    with_power = p_idle is not None
    zeros_s = torch.zeros((S,), dtype=torch.float32, device=dev)
    p_idle = zeros_s if p_idle is None else _f32(p_idle, dev)
    p_span = zeros_s if p_span is None else _f32(p_span, dev)

    amount, t_start = prob.amount, prob.t_start
    thresh = 1e-6 * amount + 1e-9
    exists = amount > 0.0
    rate_fn = SCHEDULERS[scheduler]
    prov1, cons1 = prob.provider[None], prob.consumer[None]
    limit1, perf1 = prob.limit[None], prob.perf[None]
    perf_floor = torch.clamp_min(prob.perf, 1e-30)

    t = torch.zeros((), dtype=torch.float32, device=dev)
    t_c = t
    p_r = amount
    completion = torch.where(exists, torch.inf, 0.0).to(torch.float32)
    energy = zeros_s
    n, running = 0, True
    while running and n < max_events:
        pending = exists & (p_r > thresh)
        live = pending & (t >= t_start)
        r = rate_fn(prov1, cons1, limit1, live[None], perf1,
                    max_iters=max_fill_iters)[0]
        # event horizon: the next completion or the next arrival / release
        ttc = torch.where(live & (r > 0), p_r / torch.clamp_min(r, 1e-30),
                          _BIG)
        tta = torch.where(pending & (t < t_start), t_start - t, _BIG)
        dt = torch.minimum(torch.amin(ttc), torch.amin(tta))
        go = dt < _BIG
        dt = torch.where(go, torch.clamp_min(dt, 0.0), 0.0)
        if with_power:
            delivered = segment_sum(r[None], prov1, S, where=live[None])[0]
            util = torch.clamp(delivered / perf_floor, 0.0, 1.0)
            energy = energy + (p_idle + p_span * util) * dt
        # Kahan-compensated clock
        y = dt - t_c
        t_new = t + y
        t_c = (t_new - t) - y
        t = t_new
        p_r = torch.where(live, torch.clamp_min(_drain(p_r, r, dt), 0.0), p_r)
        newly_done = live & (p_r <= thresh) & torch.isinf(completion)
        completion = torch.where(newly_done, t_new, completion)
        p_r = torch.where(newly_done, 0.0, p_r)
        n += 1
        running = bool(go)         # the pass's one host read
    processed = segment_sum((amount - p_r)[None], prov1, S)[0]
    ok = ~torch.any(exists & torch.isinf(completion))
    return SharingResult(
        completion=completion, t_end=t,
        n_events=torch.tensor(n, dtype=torch.int32, device=dev), ok=ok,
        energy=energy, processed=processed)


def run_sharing_tau(prob: SharingProblem, *, tau: float, n_steps: int,
                    scheduler: str = "maxmin") -> torch.Tensor:
    """Exact Eq. 1-2 tau-stepping over the same problem, ``n_steps`` ticks
    from the host with no read; returns completion times quantised to
    ``tau`` (inf for a consumption not done by then)."""
    dev = prob.perf.device
    C = prob.amount.shape[0]
    pool = empty_consumptions(C, device=dev)
    cons = Consumptions(
        p_u=torch.zeros((C,), dtype=torch.float32, device=dev),
        p_r=prob.amount, p_l=prob.limit, provider=prob.provider,
        consumer=prob.consumer, active=prob.amount > 0,
        t_release=prob.t_start, kind=pool.kind, ref=pool.ref,
        total=prob.amount)
    thresh = 1e-6 * prob.amount + 1e-9
    tau_t = _f32(tau, dev)
    t = torch.zeros((), dtype=torch.float32, device=dev)
    completion = torch.where(prob.amount > 0, torch.inf, 0.0).to(
        torch.float32)
    for _ in range(n_steps):
        cons = step_tau(cons, t, prob.perf, tau_t, scheduler=scheduler)
        t = t + tau_t
        done = cons.active & (cons.p_r + cons.p_u <= thresh)
        completion = torch.where(done & torch.isinf(completion), t,
                                 completion)
        cons = cons._replace(active=cons.active & ~done)
    return completion
