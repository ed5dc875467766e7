"""Mamba (selective SSM) block, the Jamba hybrid's attention-free mixer (port
of ``repro/models/ssm.py``).

in_proj -> causal depthwise conv -> selective scan -> gated out_proj, with
Jamba's RMS norms on dt/B/C.  The recurrence ``h_t = exp(dt_t A) h_{t-1} +
dt_t B_t x_t`` is diagonal per (channel, state) pair, so it flattens onto
:func:`repro_torch.kernels.ssm.linear_scan` over ``d_inner * N`` lanes, one
launch per time chunk.  As in the reference, the decay and input tensors
``(B, chunk, d_inner * N)`` are built in f32 one chunk at a time before each
call.  ``impl="pallas"`` takes the kernel (its plain version on CPU
tensors); any other ``impl`` takes the plain version, as the reference takes
``ref.linear_scan_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ssm as kssm

from ..dist.sharding import constrain
from . import common as cm
from .common import silu, spec


def mamba_spec(d_model: int, *, d_inner: int, d_state: int = 16,
               d_conv: int = 4, dt_rank: int = 0) -> dict:
    dt_rank = dt_rank or max(d_model // 16, 1)
    return {
        "in_proj": spec((d_model, 2 * d_inner), ("embed", "mlp")),
        "conv_w": spec((d_conv, d_inner), (None, "mlp"), init="normal",
                       scale=0.1),
        "conv_b": spec((d_inner,), ("mlp",), init="zeros"),
        "x_proj": spec((d_inner, dt_rank + 2 * d_state), ("mlp", None)),
        "dt_w": spec((dt_rank, d_inner), (None, "mlp")),
        "dt_bias": spec((d_inner,), ("mlp",), init="const", scale=0.01),
        "a_log": spec((d_inner, d_state), ("mlp", "state"), init="const",
                      scale=0.5),
        "d_skip": spec((d_inner,), ("mlp",), init="ones"),
        "out_proj": spec((d_inner, d_model), ("mlp", "embed")),
        "dt_norm": spec((dt_rank,), (None,), init="ones"),
        "b_norm": spec((d_state,), ("state",), init="ones"),
        "c_norm": spec((d_state,), ("state",), init="ones"),
    }


def _causal_conv(x, w, b, *, state=None):
    """Depthwise causal conv1d.  x: [B,T,di]; w: [K,di].

    ``state`` is the last K-1 inputs from the previous segment (decode);
    returns (y, new_state)."""
    K = w.shape[0]
    B, T, di = x.shape
    if state is None:
        state = torch.zeros((B, K - 1, di), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)                 # [B, T+K-1, di]
    y = torch.zeros((B, T, di), dtype=torch.float32, device=x.device)
    for i in range(K):
        y = y + xp[:, i:i + T].float() * w[i].float()
    return (y + b).to(x.dtype), xp[:, T:]


def _scan1(impl: str):
    if impl == "pallas":
        return kssm.linear_scan
    return kssm.linear_scan_plain


def _scan_chunks(a, u, h0, *, chunk: int, impl: str):
    """Diagonal recurrence over T in chunks.  a, u: [B, T, D] (flattened
    channel x state); h0: [B, D].  Returns (h_all [B,T,D], h_last [B,D]).

    A short last chunk replaces the reference's padding with identity steps
    (a = 1, u = 0): the same states, since such a step leaves h unchanged."""
    scan1 = _scan1(impl)
    T = u.shape[1]
    c = min(chunk, T)
    h = h0.float()
    hs = []
    for t0 in range(0, T, c):
        y, h = scan1(a[:, t0:t0 + c].contiguous(),
                     u[:, t0:t0 + c].contiguous(), h)
        hs.append(y)
    return torch.cat(hs, dim=1), h


def _selective_scan(dt, Bm, Cm, x_c, A, h0, *, chunk: int, impl: str):
    """Chunked selective scan with in-loop decay/input construction.

    dt, x_c: [B,T,di] f32/cdtype; Bm, Cm: [B,T,N] f32; A: [di,N] f32.
    Returns (y [B,T,di] f32, h_last [B, di*N] f32)."""
    scan1 = _scan1(impl)
    B, T, di = x_c.shape
    N = Bm.shape[-1]
    c = min(chunk, T)
    h = h0.float()
    ys = []
    for t0 in range(0, T, c):
        dt_c, B_c = dt[:, t0:t0 + c], Bm[:, t0:t0 + c]
        C_c, xc_c = Cm[:, t0:t0 + c], x_c[:, t0:t0 + c]
        n = dt_c.shape[1]
        a = torch.exp(dt_c[..., None] * A)                    # (B,n,di,N)
        u = (dt_c * xc_c.float())[..., None] * B_c[:, :, None, :]
        hs, h = scan1(a.reshape(B, n, di * N), u.reshape(B, n, di * N), h)
        ys.append(torch.einsum("btdn,btn->btd", hs.reshape(B, n, di, N), C_c))
    return torch.cat(ys, dim=1), h


def mamba_apply(p, x, *, d_state: int = 16, chunk: int = 256,
                impl: str = "chunked", state=None):
    """Mamba mixer over x: [B, T, d_model].  ``state=(conv_state,
    ssm_state)`` threads decode segments; returns (y, new_state)."""
    B, T, _ = x.shape
    di = p["conv_b"].shape[0]
    dt_rank = p["dt_norm"].shape[0]

    xz = x @ p["in_proj"].to(x.dtype)
    xz = constrain(xz, ("batch", "seq", "mlp"))
    x_in, z = torch.chunk(xz, 2, dim=-1)
    conv_state = None if state is None else state[0]
    x_c, conv_state = _causal_conv(x_in, p["conv_w"], p["conv_b"],
                                   state=conv_state)
    x_c = constrain(silu(x_c), ("batch", "seq", "mlp"))

    dbc = x_c @ p["x_proj"].to(x_c.dtype)
    dt, Bm, Cm = torch.split(dbc, [dt_rank, d_state, d_state], dim=-1)
    dt = cm.rms_norm(dt, p["dt_norm"])
    Bm = cm.rms_norm(Bm, p["b_norm"]).float()
    Cm = cm.rms_norm(Cm, p["c_norm"]).float()
    dt = cm.softplus(dt @ p["dt_w"].to(dt.dtype)
                     + p["dt_bias"].to(dt.dtype)).float()
    dt = constrain(dt, ("batch", "seq", "mlp"))

    A = -torch.exp(p["a_log"].float())                    # (di, N)
    h0 = (torch.zeros((B, di * d_state), dtype=torch.float32,
                      device=x.device) if state is None else state[1])
    y, h_last = _selective_scan(dt, Bm, Cm, x_c, A, h0, chunk=chunk,
                                impl=impl)
    y = constrain(y, ("batch", "seq", "mlp"))
    y = y + p["d_skip"].float() * x_c.float()
    y = (y * silu(z.float())).to(x.dtype)
    out = y @ p["out_proj"].to(x.dtype)
    return out, (conv_state, h_last)


def mamba_init_state(batch: int, d_inner: int, *, d_state: int = 16,
                     d_conv: int = 4, dtype=torch.float32, device=None):
    return (torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype,
                        device=device),
            torch.zeros((batch, d_inner * d_state), dtype=torch.float32,
                        device=device))
