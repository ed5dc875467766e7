"""Max-min fair-share kernels: the fused progressive-filling solve and the
round-wise per-spreader headroom over a plan (source: ``csrc/maxmin.cu``).

Replaces the Pallas TPU kernels ``repro/kernels/maxmin.py`` ``maxmin_solve``
and ``fill_stats``.  Each wrapper takes the path its tensors' device names:
a CUDA tensor launches the hand-written kernel (or the wrapper raises), a CPU
tensor runs the plain PyTorch version beside it, which computes what
``repro/kernels/ref.py`` computes.

The kernel adds every segmented sum serially in ascending flow index, as
``index_add_`` does on the CPU, and rounds each operation as the plain
version does (built with ``-fmad=false``, no fast math), so the card's rates
equal the CPU's bit for bit.

The solve works on the live flows only: one block compacts them, groups
them by provider and by consumer with a sort, and runs every round over the
touched spreaders and the live flows, in shared memory up to
``SOLVE_SMEM_FLOWS`` live flows and in one global workspace above (with
the arrays read at scattered places still in shared memory up to
``SOLVE_HOT_FLOWS``).  Its
work follows the live flows, not ``S``.  The engine routes by the size gate
``MAX_SOLVE_S`` (11,609 spreaders): the most that an earlier design of the
solve held in shared memory, kept as a routing constant.  Above the gate
the engine runs the rounds from the host (:func:`progressive_filling`): one :func:`fill_plan` per solve, a
stable CSR of the flows by provider and by consumer, then one
:func:`fill_round` per round, which walks each spreader's two segments.
The public :func:`fill_stats` is the two in one call.  Dropping the flows
outside the plan is exact (``csrc/maxmin.cu`` says why), so every path
equals ``ref.fill_stats_ref`` bit for bit.

**The lane axis.**  Every wrapper and plain version takes either one
problem (flows [C], spreaders [S]) or a batch of B independent problems
of one shape, each row a lane ([B, C], [B, S]).  One launch serves all
lanes, each lane in blocks of its own (one block a lane for the solve
and the plan, a row of blocks for the round), and a lane's result is
the result of its row alone, bit for bit: B = 1 is the single problem's
launch.  A wrapper counts one launch per call, whatever B is.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build

BIG = 3.0e38
SMEM_LIMIT = 232_448      # bytes of shared memory one Hopper block may use
STATIC_SMEM = 256         # a kernel's static reduction scratch
# live flows whose arrays the solve keeps in shared memory (csrc/maxmin.cu
# SOLVE_SMEM_FLOWS); above it they go to the global workspace
SOLVE_SMEM_FLOWS = 1024
# live flows whose rates, flags and headroom stay in shared memory when the
# rest of their arrays are in the workspace (csrc/maxmin.cu SOLVE_HOT_FLOWS)
SOLVE_HOT_FLOWS = 5120
# the solve sorts a power of two of keys at least the flow count
MAX_SOLVE_C = 2 ** 30
# the routing gate: the fused solve up to here, the round-wise path above
MAX_SOLVE_S = 11_609
# the plan kernel stages 4096 flows' two segment ids (32 KB) in shared
# memory, and keeps its two [S+1] count vectors there up to here, in global
# scratch above
PLAN_STAGE_BYTES = 2 * 4096 * 4
MAX_PLAN_SMEM_S = (SMEM_LIMIT - STATIC_SMEM - PLAN_STAGE_BYTES) // 8 - 1


class FillPlan(NamedTuple):
    """Stable CSR of the flows that can contribute to a round: segment ``s``
    of the provider side lists ``csr_p[off_p[s]:off_p[s+1]]`` in ascending
    flow index (likewise the consumer side).  int32 tensors, ``off_*`` of
    ``S + 1`` entries, ``csr_*`` of ``C`` (the tail past ``off_*[S]`` is
    unused); with a lane axis each row is one lane's plan, its flow
    indices within the lane."""
    off_p: torch.Tensor
    csr_p: torch.Tensor
    off_c: torch.Tensor
    csr_c: torch.Tensor

    def longest_segment(self) -> int:
        """The longest segment over both sides and every lane."""
        return int(max(torch.diff(self.off_p, dim=-1).max(),
                       torch.diff(self.off_c, dim=-1).max()))


def solve_fits(n_flows: int, n_spreaders: int) -> bool:
    """True below the size gate, where the engine takes the fused solve."""
    del n_flows   # the solve's live flows spill to a global workspace
    return n_spreaders <= MAX_SOLVE_S


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the card's yardstick)
# ---------------------------------------------------------------------------

def _lanes(*xs):
    """Each tensor with a leading lane axis (a 1-D one as one lane)."""
    return tuple(x if x is None or x.dim() > 1 else x[None] for x in xs)


def _per_lane(fn, *args):
    """``fn`` of one problem applied to each lane of [B, ...] arguments
    (``None`` passed through), its outputs stacked along a new lane axis:
    each lane is the 1-D plain version on its row, bit for bit."""
    rows = [fn(*(a if a is None or not torch.is_tensor(a) else a[b]
                 for a in args)) for b in range(args[0].shape[0])]
    out = [torch.stack(xs) for xs in zip(*rows)]
    return FillPlan(*out) if isinstance(rows[0], FillPlan) else tuple(out)


def fill_stats_plain(provider, consumer, r, live, unfrozen, perf):
    """Per-spreader headroom of one round (``ref.fill_stats_ref``); of each
    lane for [B, ...] inputs."""
    if perf.dim() > 1:
        return _per_lane(fill_stats_plain, provider, consumer, r, live,
                         unfrozen, perf)
    S = perf.shape[0]
    rl = torch.where(live, r, 0.0)
    uf = unfrozen.to(torch.float32)

    def seg(x, ids):
        return torch.zeros((S,), dtype=torch.float32,
                           device=x.device).index_add_(0, ids.long(), x)

    committed_p, committed_c = seg(rl, provider), seg(rl, consumer)
    cnt_p, cnt_c = seg(uf, provider), seg(uf, consumer)
    avail_p = torch.clamp_min(perf - committed_p, 0.0)
    avail_c = torch.clamp_min(perf - committed_c, 0.0)
    dp = torch.where(cnt_p > 0, avail_p / torch.clamp_min(cnt_p, 1.0), BIG)
    dc = torch.where(cnt_c > 0, avail_c / torch.clamp_min(cnt_c, 1.0), BIG)
    return dp, dc


def fill_plan_plain(provider, consumer, live, unfrozen, n_spreaders: int
                    ) -> FillPlan:
    """The plan of the flows with ``live | unfrozen`` (``live`` alone when
    ``unfrozen`` is None): a stable sort of their indices by segment; of
    each lane for [B, C] inputs."""
    if provider.dim() > 1:
        return _per_lane(fill_plan_plain, provider, consumer, live, unfrozen,
                         n_spreaders)
    keep = live if unfrozen is None else live | unfrozen
    idx = torch.nonzero(keep).flatten()
    C = provider.shape[0]

    def side(ids):
        seg = ids[idx].long()
        order = torch.argsort(seg, stable=True)
        csr = torch.zeros((C,), dtype=torch.int32, device=ids.device)
        csr[:idx.numel()] = idx[order].to(torch.int32)
        counts = torch.bincount(seg, minlength=n_spreaders)
        off = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        return off.to(torch.int32), csr

    (off_p, csr_p), (off_c, csr_c) = side(provider), side(consumer)
    return FillPlan(off_p, csr_p, off_c, csr_c)


def fill_round_plain(plan: FillPlan, r, live, unfrozen, perf):
    """One round's ``(dp, dc)`` summed over the plan's segments in plan
    order (``index_add_`` on the CPU adds serially, so each segment's terms
    go in ascending flow index, as in :func:`fill_stats_plain`); of each
    lane for [B, ...] inputs."""
    if perf.dim() > 1:
        return _per_lane(lambda *a: fill_round_plain(FillPlan(*a[:4]),
                                                     *a[4:]),
                         *plan, r, live, unfrozen, perf)
    S = perf.shape[0]
    rl = torch.where(live, r, 0.0)
    uf = unfrozen.to(torch.float32)

    def seg(off, csr, x):
        # each plan entry's segment id: the number of segment ends at or
        # before it (the ids repeated by their counts; on the CPU a search
        # takes a small part of repeat_interleave's host time)
        off = off.long()
        ids = torch.searchsorted(off[1:], torch.arange(
            int(off[-1]), device=off.device), right=True)
        j = csr[:ids.numel()].long()
        return torch.zeros((S,), dtype=torch.float32,
                           device=x.device).index_add_(0, ids, x[j])

    out = []
    for off, csr in ((plan.off_p, plan.csr_p), (plan.off_c, plan.csr_c)):
        committed, cnt = seg(off, csr, rl), seg(off, csr, uf)
        avail = torch.clamp_min(perf - committed, 0.0)
        out.append(torch.where(cnt > 0, avail / torch.clamp_min(cnt, 1.0),
                               BIG))
    return tuple(out)


def progressive_filling(provider, consumer, p_l, live, perf, round_fn, *,
                        plan_fn=None, max_iters: int = 64,
                        rel_eps: float = 1e-5):
    """The round recurrence of ``ref.maxmin_solve_ref`` driven from the host:
    one ``plan_fn(provider, consumer, live, None, S)`` (default
    :func:`fill_plan`) before the first round, then one ``round_fn(plan, r,
    live, unfrozen, perf)`` per round; the host reads "any lane has an
    unfrozen flow" once per round.  Each lane's round raises its unfrozen
    flows by its own ``delta``; a lane with no unfrozen flow left gets
    ``delta = 0`` and stays as it was, so each lane ends with the rates
    of its rounds alone (the rounds all lanes share start together, and
    ``max_iters`` caps every lane alike)."""
    plan_fn = fill_plan if plan_fn is None else plan_fn
    one = provider.dim() == 1
    provider, consumer, p_l, live, perf = _lanes(provider, consumer, p_l,
                                                 live, perf)
    prov, cons = provider.long(), consumer.long()
    r = torch.zeros(p_l.shape, dtype=torch.float32, device=p_l.device)
    unfrozen = live
    plan = None
    for _ in range(max_iters):
        if not bool(unfrozen.any()):
            break
        if plan is None:
            # unfrozen stays a subset of live: one plan serves every round
            plan = plan_fn(provider, consumer, live, None, perf.shape[-1])
        dp, dc = round_fn(plan, r, live, unfrozen, perf)
        df = torch.minimum(dp.gather(1, prov), dc.gather(1, cons))
        df = torch.minimum(df, torch.clamp_min(p_l - r, 0.0))
        df = torch.where(unfrozen, df, BIG)
        delta = torch.amin(df, dim=1, keepdim=True)
        delta = torch.where(torch.isfinite(delta) & (delta < BIG), delta, 0.0)
        r = torch.where(unfrozen, r + delta, r)
        tight = df <= delta * (1.0 + rel_eps) + 1e-12
        unfrozen = unfrozen & ~tight
    r = torch.where(live, r, 0.0)
    return r[0] if one else r


def maxmin_solve_plain(provider, consumer, p_l, live, perf, *,
                       max_iters: int = 64, rel_eps: float = 1e-5):
    """Full progressive-filling solve (``ref.maxmin_solve_ref``), of each
    lane."""
    return progressive_filling(provider, consumer, p_l, live, perf,
                               fill_round_plain, plan_fn=fill_plan_plain,
                               max_iters=max_iters, rel_eps=rel_eps)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("maxmin")
    if not getattr(lib, "_typed", False):
        lib.maxmin_solve_launch.argtypes = [_P] * 7 + [_I, _I, _I, _I,
                                                       ctypes.c_float, _P]
        lib.maxmin_solve_launch.restype = _I
        lib.maxmin_solve_scratch_bytes.argtypes = [_I]
        lib.maxmin_solve_scratch_bytes.restype = ctypes.c_size_t
        lib.fill_plan_launch.argtypes = [_P] * 9 + [_I, _I, _I, _P]
        lib.fill_plan_launch.restype = _I
        lib.fill_round_launch.argtypes = [_P] * 10 + [_I, _I, _I, _P]
        lib.fill_round_launch.restype = _I
        lib._typed = True
    return lib


# lanes one launch takes: the round's lanes are a grid's y extent
MAX_LANES = 65535


def _lane_shape(name: str, t: torch.Tensor) -> tuple[int, ...]:
    """``()`` for one problem, ``(B,)`` for B lanes; raises on other
    ranks and on more lanes than one launch takes."""
    if t.dim() == 1:
        return ()
    if t.dim() == 2 and 1 <= t.shape[0] <= MAX_LANES:
        return (t.shape[0],)
    raise ValueError(f"{name}: expected [C] or [B, C] with 1 <= B <= "
                     f"{MAX_LANES}, got shape {tuple(t.shape)}")


def _check(name: str, device, C: int, S: int, lead: tuple, **tensors):
    for arg, (t, dtype, n) in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected "
                            f"{dtype}")
        if t.shape != lead + (n,):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {lead + (n,)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if C >= 2 ** 31 or S >= 2 ** 31 - 1:
        raise ValueError(f"{name}: sizes exceed the kernel's int32 indexing")


def _stream(device) -> int:
    """The raw handle of the current stream on ``device`` (the current
    device when it names no index), read without building a
    ``torch.cuda.Stream`` object."""
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def _route(t: torch.Tensor, name: str) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version (CPU
    tensor); any other device raises."""
    if t.is_cuda:
        return True
    if t.is_cpu:
        return False
    raise ValueError(f"{name}: no kernel or plain version for device "
                     f"{t.device}")


def no_grad_through(name: str, *tensors) -> None:
    """Raise when grad is enabled and one of ``tensors`` (None skipped)
    requires grad: the kernel ``name`` has no backward, and its output
    would silently cut the graph."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward and an input requires "
            f"grad; train through the plain path (attn_impl=\"chunked\") "
            f"or call it under torch.no_grad()")


@functools.lru_cache(maxsize=None)
def _thr_scale(rel_eps: float) -> float:
    """``1 + rel_eps`` rounded to f32, as the plain version's product
    rounds it."""
    return float(np.float32(1.0 + rel_eps))


@functools.lru_cache(maxsize=None)
def solve_scratch_bytes(n_flows: int) -> int:
    """Bytes of one lane's slice of the solve's global workspace for
    ``n_flows`` flows (0 when all of them fit in shared memory)."""
    return int(_lib().maxmin_solve_scratch_bytes(n_flows))


def maxmin_solve(provider, consumer, p_l, live, perf, *,
                 max_iters: int = 64, rel_eps: float = 1e-5):
    """Max-min fair rates by progressive filling, solved in one launch for
    one problem ([C] flows, [S] spreaders) or for B lanes ([B, C],
    [B, S]), one block a lane.

    Provider and consumer indices must lie in ``[0, S)``.  Guard call sites
    with :func:`solve_fits`.  Returns a fresh ``r`` of the flows' shape
    each call."""
    if not _route(provider, "maxmin_solve"):
        return maxmin_solve_plain(provider, consumer, p_l, live, perf,
                                  max_iters=max_iters, rel_eps=rel_eps)
    lead = _lane_shape("maxmin_solve", provider)
    B = lead[0] if lead else 1
    C, S = provider.shape[-1], perf.shape[-1]
    dev = provider.device
    _check("maxmin_solve", dev, C, S, lead,
           provider=(provider, torch.int32, C),
           consumer=(consumer, torch.int32, C),
           p_l=(p_l, torch.float32, C), live=(live, torch.bool, C),
           perf=(perf, torch.float32, S))
    if not solve_fits(C, S):
        raise ValueError(f"maxmin_solve: S={S} spreaders lie above the "
                         f"routing gate MAX_SOLVE_S={MAX_SOLVE_S}; the "
                         f"engine takes progressive_filling there")
    if C >= MAX_SOLVE_C:
        raise ValueError(f"maxmin_solve: C={C} flows exceed the sort's "
                         f"limit MAX_SOLVE_C={MAX_SOLVE_C}")
    r = torch.empty(lead + (C,), dtype=torch.float32, device=dev)
    n_scratch = solve_scratch_bytes(C)
    # one workspace, a slice a lane carved by the kernel, only when the
    # live flows may outgrow shared memory
    scratch = (torch.empty((B * n_scratch,), dtype=torch.uint8, device=dev)
               if n_scratch else None)
    err = _lib().maxmin_solve_launch(
        provider.data_ptr(), consumer.data_ptr(), p_l.data_ptr(),
        live.data_ptr(), perf.data_ptr(), r.data_ptr(),
        None if scratch is None else scratch.data_ptr(), C, S, B,
        int(max_iters), _thr_scale(rel_eps), _stream(dev))
    if err != 0:
        raise RuntimeError(f"maxmin_solve: kernel launch failed with CUDA "
                           f"error {err}")
    maxmin_solve.launches += 1
    return r


maxmin_solve.launches = 0


def fill_plan(provider, consumer, live, unfrozen, n_spreaders: int
              ) -> FillPlan:
    """The plan of the flows with ``live | unfrozen`` (``unfrozen`` may be
    None), built on the card by one launch, one block a lane."""
    if not _route(provider, "fill_plan"):
        return fill_plan_plain(provider, consumer, live, unfrozen,
                               n_spreaders)
    lead = _lane_shape("fill_plan", provider)
    B = lead[0] if lead else 1
    C, S = provider.shape[-1], n_spreaders
    dev = provider.device
    masks = dict(live=(live, torch.bool, C))
    if unfrozen is not None:
        masks["unfrozen"] = (unfrozen, torch.bool, C)
    _check("fill_plan", dev, C, S, lead, provider=(provider, torch.int32, C),
           consumer=(consumer, torch.int32, C), **masks)
    i32 = dict(dtype=torch.int32, device=dev)
    plan = FillPlan(torch.empty(lead + (S + 1,), **i32),
                    torch.empty(lead + (C,), **i32),
                    torch.empty(lead + (S + 1,), **i32),
                    torch.empty(lead + (C,), **i32))
    scratch = (None if S <= MAX_PLAN_SMEM_S
               else torch.empty((B * 2 * (S + 1),), **i32))
    err = _lib().fill_plan_launch(
        provider.data_ptr(), consumer.data_ptr(), live.data_ptr(),
        0 if unfrozen is None else unfrozen.data_ptr(),
        plan.off_p.data_ptr(), plan.csr_p.data_ptr(), plan.off_c.data_ptr(),
        plan.csr_c.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
        C, S, B, _stream(dev))
    if err != 0:
        raise RuntimeError(f"fill_plan: kernel launch failed with CUDA "
                           f"error {err}")
    fill_plan.launches += 1
    return plan


fill_plan.launches = 0


def fill_round(plan: FillPlan, r, live, unfrozen, perf):
    """Per-spreader headroom ``(dp, dc)`` of one round, walked over a plan
    that holds every flow with ``live | unfrozen``, in one launch for every
    lane.  Its launches count in ``fill_stats.launches``: it is the kernel
    that replaces the TPU ``fill_stats``."""
    if not _route(r, "fill_round"):
        return fill_round_plain(plan, r, live, unfrozen, perf)
    lead = _lane_shape("fill_round", r)
    B = lead[0] if lead else 1
    C, S = r.shape[-1], perf.shape[-1]
    dev = r.device
    _check("fill_round", dev, C, S, lead, r=(r, torch.float32, C),
           live=(live, torch.bool, C), unfrozen=(unfrozen, torch.bool, C),
           perf=(perf, torch.float32, S), off_p=(plan.off_p, torch.int32,
                                                  S + 1),
           off_c=(plan.off_c, torch.int32, S + 1),
           csr_p=(plan.csr_p, torch.int32, C),
           csr_c=(plan.csr_c, torch.int32, C))
    dp = torch.empty(lead + (S,), dtype=torch.float32, device=dev)
    dc = torch.empty(lead + (S,), dtype=torch.float32, device=dev)
    err = _lib().fill_round_launch(
        plan.off_p.data_ptr(), plan.csr_p.data_ptr(), plan.off_c.data_ptr(),
        plan.csr_c.data_ptr(), r.data_ptr(), live.data_ptr(),
        unfrozen.data_ptr(), perf.data_ptr(), dp.data_ptr(), dc.data_ptr(),
        C, S, B, _stream(dev))
    if err != 0:
        raise RuntimeError(f"fill_round: kernel launch failed with CUDA "
                           f"error {err}")
    fill_stats.launches += 1
    return dp, dc


def fill_stats(provider, consumer, r, live, unfrozen, perf):
    """Per-spreader headroom ``(dp, dc)`` of one progressive-filling round
    (``ref.fill_stats_ref``, for any inputs), of one problem or of each
    lane.  On the card it builds its own plan and walks it: two launches,
    one :func:`fill_plan` and one :func:`fill_round`."""
    if not _route(provider, "fill_stats"):
        return fill_stats_plain(provider, consumer, r, live, unfrozen, perf)
    S = perf.shape[-1]
    plan = fill_plan(provider, consumer, live, unfrozen, S)
    return fill_round(plan, r, live, unfrozen, perf)


fill_stats.launches = 0
