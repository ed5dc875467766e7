"""Max-min fair-share kernels: the fused progressive-filling solve and the
round-wise per-spreader headroom (source: ``csrc/maxmin.cu``).

Replaces the Pallas TPU kernels ``repro/kernels/maxmin.py`` ``maxmin_solve``
and ``fill_stats``.  Each wrapper takes the path its tensors' device names:
a CUDA tensor launches the hand-written kernel (or the wrapper raises), a CPU
tensor runs the plain PyTorch version beside it, which computes what
``repro/kernels/ref.py`` computes.

The kernel adds every segmented sum serially in ascending flow index, as
``index_add_`` does on the CPU, and rounds each operation as the plain
version does (built with ``-fmad=false``, no fast math), so the card's rates
equal the CPU's bit for bit.

Size gate: the solve keeps ``perf``, the two headroom vectors and the two
CSR offset vectors of all ``S`` spreaders in one block's shared memory,
``20 * S + 8`` bytes beside 256 static bytes, within the 227 KB a Hopper
block may use: ``S <= MAX_SOLVE_S`` (11,609).  The flows stay in global
memory (L2), so the flow count is not limited.  Above the gate the engine
runs the rounds from the host through :func:`fill_stats`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

BIG = 3.0e38
SMEM_LIMIT = 232_448      # bytes of shared memory one Hopper block may use
STATIC_SMEM = 256         # the solve kernel's static reduction scratch


def solve_smem_bytes(n_spreaders: int) -> int:
    """Dynamic shared memory of one solve: perf, dp, dc [S] f32 and the two
    CSR offset vectors [S+1] i32."""
    return 12 * n_spreaders + 8 * (n_spreaders + 1)


MAX_SOLVE_S = (SMEM_LIMIT - STATIC_SMEM - 8) // 20


def solve_fits(n_flows: int, n_spreaders: int) -> bool:
    """True when the fused solve's shared-memory footprint fits one block."""
    del n_flows   # the flows live in global memory
    return n_spreaders <= MAX_SOLVE_S


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the card's yardstick)
# ---------------------------------------------------------------------------

def fill_stats_plain(provider, consumer, r, live, unfrozen, perf):
    """Per-spreader headroom of one round (``ref.fill_stats_ref``)."""
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


def progressive_filling(provider, consumer, p_l, live, perf, fill_stats_fn,
                        *, max_iters: int = 64, rel_eps: float = 1e-5):
    """The round recurrence of ``ref.maxmin_solve_ref`` driven from the host,
    one ``fill_stats_fn`` call per round; the host reads ``unfrozen.any()``
    once per round."""
    prov, cons = provider.long(), consumer.long()
    r = torch.zeros(p_l.shape, dtype=torch.float32, device=p_l.device)
    unfrozen = live
    for _ in range(max_iters):
        if not bool(unfrozen.any()):
            break
        dp, dc = fill_stats_fn(provider, consumer, r, live, unfrozen, perf)
        df = torch.minimum(dp[prov], dc[cons])
        df = torch.minimum(df, torch.clamp_min(p_l - r, 0.0))
        df = torch.where(unfrozen, df, BIG)
        delta = torch.min(df)
        delta = torch.where(torch.isfinite(delta) & (delta < BIG), delta, 0.0)
        r = torch.where(unfrozen, r + delta, r)
        tight = df <= delta * (1.0 + rel_eps) + 1e-12
        unfrozen = unfrozen & ~tight
    return torch.where(live, r, 0.0)


def maxmin_solve_plain(provider, consumer, p_l, live, perf, *,
                       max_iters: int = 64, rel_eps: float = 1e-5):
    """Full progressive-filling solve (``ref.maxmin_solve_ref``)."""
    return progressive_filling(provider, consumer, p_l, live, perf,
                               fill_stats_plain, max_iters=max_iters,
                               rel_eps=rel_eps)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("maxmin")
    if not getattr(lib, "_typed", False):
        lib.maxmin_solve_launch.argtypes = [_P] * 10 + [_I, _I, _I,
                                                        ctypes.c_float, _P]
        lib.maxmin_solve_launch.restype = _I
        lib.fill_stats_launch.argtypes = [_P] * 8 + [_I, _I, _P]
        lib.fill_stats_launch.restype = _I
        lib._typed = True
    return lib


def _check(name: str, device, C: int, S: int, **tensors):
    for arg, (t, dtype, n) in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected "
                            f"{dtype}")
        if t.shape != (n,):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected ({n},)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if C >= 2 ** 31 or S >= 2 ** 31 - 1:
        raise ValueError(f"{name}: sizes exceed the kernel's int32 indexing")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _route(t: torch.Tensor, name: str) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version (CPU
    tensor); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device "
                     f"{t.device}")


def maxmin_solve(provider, consumer, p_l, live, perf, *,
                 max_iters: int = 64, rel_eps: float = 1e-5):
    """Max-min fair rates by progressive filling, solved in one launch.

    Provider and consumer indices must lie in ``[0, S)``.  Guard call sites
    with :func:`solve_fits`."""
    if not _route(provider, "maxmin_solve"):
        return maxmin_solve_plain(provider, consumer, p_l, live, perf,
                                  max_iters=max_iters, rel_eps=rel_eps)
    C, S = provider.shape[0], perf.shape[0]
    dev = provider.device
    _check("maxmin_solve", dev, C, S,
           provider=(provider, torch.int32, C),
           consumer=(consumer, torch.int32, C),
           p_l=(p_l, torch.float32, C), live=(live, torch.bool, C),
           perf=(perf, torch.float32, S))
    if not solve_fits(C, S):
        raise ValueError(f"maxmin_solve: S={S} spreaders exceed the "
                         f"shared-memory gate MAX_SOLVE_S={MAX_SOLVE_S}")
    r = torch.empty((C,), dtype=torch.float32, device=dev)
    df = torch.empty((C,), dtype=torch.float32, device=dev)
    unfrozen = torch.empty((C,), dtype=torch.uint8, device=dev)
    csr_p = torch.empty((C,), dtype=torch.int32, device=dev)
    csr_c = torch.empty((C,), dtype=torch.int32, device=dev)
    thr_scale = float(np.float32(1.0 + rel_eps))
    err = _lib().maxmin_solve_launch(
        provider.data_ptr(), consumer.data_ptr(), p_l.data_ptr(),
        live.data_ptr(), perf.data_ptr(), r.data_ptr(), df.data_ptr(),
        unfrozen.data_ptr(), csr_p.data_ptr(), csr_c.data_ptr(),
        C, S, int(max_iters), thr_scale, _stream(dev))
    if err != 0:
        raise RuntimeError(f"maxmin_solve: kernel launch failed with CUDA "
                           f"error {err}")
    maxmin_solve.launches += 1
    return r


maxmin_solve.launches = 0


def fill_stats(provider, consumer, r, live, unfrozen, perf):
    """Per-spreader headroom ``(dp, dc)`` of one progressive-filling round."""
    if not _route(provider, "fill_stats"):
        return fill_stats_plain(provider, consumer, r, live, unfrozen, perf)
    C, S = provider.shape[0], perf.shape[0]
    dev = provider.device
    _check("fill_stats", dev, C, S,
           provider=(provider, torch.int32, C),
           consumer=(consumer, torch.int32, C),
           r=(r, torch.float32, C), live=(live, torch.bool, C),
           unfrozen=(unfrozen, torch.bool, C),
           perf=(perf, torch.float32, S))
    dp = torch.empty((S,), dtype=torch.float32, device=dev)
    dc = torch.empty((S,), dtype=torch.float32, device=dev)
    err = _lib().fill_stats_launch(
        provider.data_ptr(), consumer.data_ptr(), r.data_ptr(),
        live.data_ptr(), unfrozen.data_ptr(), perf.data_ptr(),
        dp.data_ptr(), dc.data_ptr(), C, S, _stream(dev))
    if err != 0:
        raise RuntimeError(f"fill_stats: kernel launch failed with CUDA "
                           f"error {err}")
    fill_stats.launches += 1
    return dp, dc


fill_stats.launches = 0
