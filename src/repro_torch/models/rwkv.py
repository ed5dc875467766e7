"""RWKV6 ("Finch", arXiv:2404.05892), the attention-free token mixer with
data-dependent decay (port of ``repro/models/rwkv.py``).

Per head ``h`` with key/value dims ``K=V=head_size``:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (state: [K, V])
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

``w_t`` is data-dependent via a low-rank MLP on the token-shifted input; the
five projections (r,k,v,w,g) each get their own data-dependent token-shift
mix (``time_maa``).  Channel mixing is the squared-relu MLP with a sigmoid
receptance gate.

Like the reference, this path reaches no kernel: the recurrence runs in
plain PyTorch, as a token loop (:func:`_wkv_chunks`, what decode runs) or
in windows of :data:`WKV_WINDOW` tokens (:func:`_wkv_chunks_matmul`).  Every
projection computes in f32, so the time and channel mixes' weights are kept
in f32 whatever the compute dtype.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from . import common as cm
from .common import silu, spec

MAA_RANK = 32
DECAY_RANK = 64


def _wkv_chunks(r, k, v, w, u, s0, *, chunk: int):
    """The WKV recurrence one token at a time.

    r, k, w: [B,T,H,K] f32; v: [B,T,H,V] f32; u: [H,K] f32;
    s0: [B,H,K,V] f32.  Returns (y [B,T,H,V] f32, s_last).

    The reference pads T to a multiple of ``chunk`` with r = k = v = 0 and
    w = 1: such a step leaves the state as it is, so the loop stops at T
    instead (``chunk`` is kept for the reference's signature)."""
    del chunk
    S = s0
    ys = []
    for t in range(k.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]
        y_t = torch.einsum("bhk,bhkv->bhv", r_t, S)
        y_t = y_t + torch.einsum("bhk,hk,bhk->bh", r_t, u,
                                 k_t)[..., None] * v_t
        S = w_t[..., None] * S + k_t[..., None] * v_t[..., None, :]
        ys.append(y_t)
    return torch.stack(ys, dim=1), S


WKV_WINDOW = 8          # intra-window exponents bounded by WINDOW*CLAMP
WKV_LOG_CLAMP = 8.0     # per-token |log w| clamp (w >= e^-8, GLA-style)


def _wkv_chunks_matmul(r, k, v, w, u, s0, *, window: int = WKV_WINDOW):
    """GLA-style windowed WKV: within a window of ``window`` tokens the decay
    products factor as ``exp(P_t - P_0) * exp(P_0 - P_s)`` with ``P_t`` the
    cumulative log-decay from the window start, clamped per token to
    ``[-WKV_LOG_CLAMP, 0]``, so the s < t interaction is one masked
    ``window x window`` product per head.

    Everything that does not read the carried state is computed for all
    windows at once; only the state's update runs window by window, as the
    reference's ``lax.scan`` does.  Same arguments and results as
    :func:`_wkv_chunks` (up to the decay clamp)."""
    B, T, H, K = k.shape
    V = v.shape[-1]
    c = window
    Tp = -(-T // c) * c
    nw = Tp // c

    def prep(t, fill=0.0):
        t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, Tp - T), value=fill)
        return t.reshape(B, nw, c, H, t.shape[-1])

    rc, kc, vc, wc = prep(r), prep(k), prep(v), prep(w, fill=1.0)
    mask = torch.tril(torch.ones((c, c), dtype=torch.float32,
                                 device=k.device), diagonal=-1)
    logw = torch.clamp(torch.log(torch.clamp(wc, min=1e-38)),
                       -WKV_LOG_CLAMP, 0.0)
    P = torch.cumsum(logw, dim=2)               # (B,nw,c,H,K), incl. w_t
    r_in = rc * torch.exp(P - logw)             # r_t e^{P_{t-1}}  (<= 1)
    k_out = kc * torch.exp(-P)                  # k_s e^{-P_s}     (<= e^64)
    A = torch.einsum("bwthk,bwshk->bwhts", r_in, k_out) * mask
    bonus = torch.einsum("bwthk,hk,bwthk->bwth", rc, u, kc)
    y = torch.einsum("bwhts,bwshv->bwthv", A, vc) + bonus[..., None] * vc
    decay_all = torch.exp(P[:, :, -1])          # e^{P_c}: (B,nw,H,K)
    k_tail = kc * torch.exp(P[:, :, -1:] - P)   # e^{P_c - P_s} (<= 1)
    kv = torch.einsum("bwshk,bwshv->bwhkv", k_tail, vc)
    S = s0
    starts = []
    for i in range(nw):
        starts.append(S)
        S = decay_all[:, i, ..., None] * S + kv[:, i]
    y = y + torch.einsum("bwthk,bwhkv->bwthv", r_in,
                         torch.stack(starts, dim=1))
    return y.reshape(B, Tp, H, V)[:, :T], S


def rwkv_time_spec(d: int, *, head_size: int = 64) -> dict:
    H = d // head_size
    return {
        "maa_x": spec((d,), ("embed",), init="zeros"),
        "maa_rkvwg": spec((5, d), (None, "embed"), init="zeros"),
        "maa_w1": spec((d, 5 * MAA_RANK), ("embed", None), init="normal",
                       scale=1e-4),
        "maa_w2": spec((5, MAA_RANK, d), (None, None, "embed"), init="normal",
                       scale=0.02),
        "decay_base": spec((d,), ("embed",), init="const", scale=-4.0),
        "decay_w1": spec((d, DECAY_RANK), ("embed", None), init="normal",
                         scale=1e-4),
        "decay_w2": spec((DECAY_RANK, d), (None, "embed"), init="normal",
                         scale=0.02),
        "bonus": spec((H, head_size), ("q_heads", "head"), init="normal",
                      scale=0.5),
        "w_r": spec((d, d), ("embed", "heads_flat")),
        "w_k": spec((d, d), ("embed", "heads_flat")),
        "w_v": spec((d, d), ("embed", "heads_flat")),
        "w_g": spec((d, d), ("embed", "heads_flat")),
        "w_o": spec((d, d), ("heads_flat", "embed")),
        "ln_w": spec((d,), ("embed",), init="ones"),
        "ln_b": spec((d,), ("embed",), init="zeros"),
    }


def rwkv_channel_spec(d: int, d_ff: int) -> dict:
    return {
        "maa_k": spec((d,), ("embed",), init="zeros"),
        "maa_r": spec((d,), ("embed",), init="zeros"),
        "w_k": spec((d, d_ff), ("embed", "mlp")),
        "w_v": spec((d_ff, d), ("mlp", "embed")),
        "w_r": spec((d, d), ("embed", "embed2")),
    }


def _token_shift(x, last):
    """Shift right by one along T; ``last`` [B,1,d] seeds position 0."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1), x[:, -1:]


def rwkv_time_mix(p, x, *, head_size: int = 64, chunk: int = 256,
                  impl: str = "chunked", state=None):
    """x: [B,T,d] -> (y, new_state).  state = (shift [B,1,d], S [B,H*K*V]).
    The windowed form runs when ``impl == "matmul"`` and T >= WKV_WINDOW,
    the token loop otherwise (decode)."""
    B, T, d = x.shape
    H = d // head_size
    K = V = head_size
    shift0 = None if state is None else state[0]
    xx, shift1 = _token_shift(x, shift0)
    dx = xx - x

    xf = x.float()
    dxf = dx.float()
    # data-dependent token-shift mixing (time_maa)
    base = xf + dxf * p["maa_x"]
    lora = torch.tanh(base @ p["maa_w1"]).reshape(B, T, 5, MAA_RANK)
    mixes = p["maa_rkvwg"][None, None] + torch.einsum(
        "btfr,frd->btfd", lora, p["maa_w2"])          # (B,T,5,d)
    xr, xk, xv, xw, xg = [xf + dxf * mixes[:, :, i] for i in range(5)]

    r = (xr @ p["w_r"].float()).reshape(B, T, H, K)
    k = (xk @ p["w_k"].float()).reshape(B, T, H, K)
    v = (xv @ p["w_v"].float()).reshape(B, T, H, V)
    g = silu(xg @ p["w_g"].float())

    # data-dependent decay w_t in (0,1)
    dec = p["decay_base"] + torch.tanh(xw @ p["decay_w1"]) @ p["decay_w2"]
    w = torch.exp(-torch.exp(dec.float())).reshape(B, T, H, K)

    u = p["bonus"].float()                              # (H, K)
    s0 = (torch.zeros((B, H, K, V), dtype=torch.float32, device=x.device)
          if state is None else state[1].float().reshape(B, H, K, V))
    if impl == "matmul" and T >= WKV_WINDOW:
        y, s_last = _wkv_chunks_matmul(r, k, v, w, u, s0)
    else:
        y, s_last = _wkv_chunks(r, k, v, w, u, s0, chunk=chunk)
    s_last = s_last.reshape(B, -1)
    y = y.reshape(B, T, d)
    y = cm.group_norm(y, p["ln_w"], p["ln_b"], H) * g
    out = (y @ p["w_o"].float()).to(x.dtype)
    return out, (shift1.to(x.dtype), s_last)


def rwkv_channel_mix(p, x, *, state=None):
    """Squared-relu channel mix.  state = shift [B,1,d]."""
    xx, shift1 = _token_shift(x, state)
    dx = (xx - x).float()
    xf = x.float()
    xk = xf + dx * p["maa_k"]
    xr = xf + dx * p["maa_r"]
    kk = torch.square(torch.relu(xk @ p["w_k"].float()))
    vv = kk @ p["w_v"].float()
    out = torch.sigmoid(xr @ p["w_r"].float()) * vv
    return out.to(x.dtype), shift1.to(x.dtype)


def rwkv_init_state(batch: int, d: int, *, head_size: int = 64,
                    dtype=torch.float32, device=None):
    """Zero decode state of one RWKV layer on ``device`` (the GPU by
    default)."""
    dev = resolve_device(device)
    H = d // head_size
    return {
        "tm_shift": torch.zeros((batch, 1, d), dtype=dtype, device=dev),
        "tm_state": torch.zeros((batch, H * head_size * head_size),
                                dtype=torch.float32, device=dev),
        "cm_shift": torch.zeros((batch, 1, d), dtype=dtype, device=dev),
    }
