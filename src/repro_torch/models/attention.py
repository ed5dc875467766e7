"""Scaled-dot-product attention with three interchangeable backends (port of
``repro/models/attention.py``).

* ``impl="chunked"`` — flash-style attention in plain PyTorch: a loop over
  query chunks, online softmax over KV chunks.  It serves the cache path
  (prefill and decode) whatever ``impl`` says, as in the reference.
* ``impl="pallas"`` — the hand-written kernel
  :func:`repro_torch.kernels.attention.flash_attention` (its plain version on
  CPU tensors), taken under the reference's own gate: no ``kv_len`` and an
  integer ``q_offset``.
* ``impl="naive"`` — materialises the full score matrix.

``kv_len`` (the valid length of a preallocated cache) is a host int here:
the serving loop knows it.  ``cache_update`` writes into the cache tensors in
place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import attention as kattn

NEG = -1e30


def _mask(qpos, kpos, *, causal, window, prefix_len, kv_len):
    """Boolean visibility mask [..., Tq, Tk] from absolute positions."""
    qp = qpos[..., :, None]
    kp = kpos[..., None, :]
    m = torch.ones(qp.shape[:-1] + kp.shape[-1:], dtype=torch.bool,
                   device=qpos.device)
    if causal:
        c = kp <= qp
        if window and window > 0:
            c = c & (kp > qp - window)
        if prefix_len and prefix_len > 0:
            c = c | (kp < prefix_len)
        m = m & c
    if kv_len is not None:
        m = m & (kp < kv_len)
    return m


def naive_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    prefix_len=0, q_offset=0, scale=None, kv_len=None):
    B, Tq, Hq, D = q.shape
    _, Tk, Hkv, _ = k.shape
    g = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale
    qr = q.reshape(B, Tq, Hkv, g, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr.float(), k.float()) * scale
    if softcap and softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(Tq, device=q.device) + q_offset
    kpos = torch.arange(Tk, device=q.device)
    m = _mask(qpos, kpos, causal=causal, window=window, prefix_len=prefix_len,
              kv_len=kv_len)
    s = torch.where(m, s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Tq, Hq, D).to(q.dtype)


def chunked_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                      prefix_len=0, q_offset=0, scale=None, kv_len=None,
                      q_chunk=512, k_chunk=1024):
    """Flash-style two-level chunked attention (see module docstring).

    KV chunks that lie wholly at or beyond the valid length are skipped:
    every key there is masked, so the reference's step over them leaves the
    running max, normaliser and accumulator unchanged."""
    B, Tq, Hq, D = q.shape
    _, Tk, Hkv, _ = k.shape
    g = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale
    cq = min(q_chunk, Tq)
    ck = min(k_chunk, Tk)
    nq, nk = -(-Tq // cq), -(-Tk // ck)
    klen = min(Tk, kv_len) if kv_len is not None else Tk
    dev = q.device

    def pad(x, n):
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n - x.shape[1]))

    qp, kp, vp = pad(q, nq * cq), pad(k, nk * ck), pad(v, nk * ck)
    outs = []
    for qi in range(nq):
        qc = qp[:, qi * cq:(qi + 1) * cq].reshape(B, cq, Hkv, g, D)
        q32 = qc.float() * scale
        qpos = q_offset + qi * cq + torch.arange(cq, device=dev)
        m_run = torch.full((B, cq, Hkv, g), NEG, device=dev)
        l_run = torch.zeros((B, cq, Hkv, g), device=dev)
        acc = torch.zeros((B, cq, Hkv, g, D), device=dev)
        for ki in range(nk):
            if ki * ck >= klen:
                break
            kc = kp[:, ki * ck:(ki + 1) * ck]
            vc = vp[:, ki * ck:(ki + 1) * ck]
            s = torch.einsum("bqhgd,bkhd->bqhgk", q32, kc.float())
            if softcap and softcap > 0:
                s = softcap * torch.tanh(s / softcap)
            kpos = ki * ck + torch.arange(ck, device=dev)
            msk = _mask(qpos, kpos, causal=causal, window=window,
                        prefix_len=prefix_len, kv_len=klen)
            msk = msk[None, :, None, None, :]
            s = torch.where(msk, s, NEG)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(msk, p, 0.0)
            alpha = torch.exp(m_run - m_new)
            l_run = l_run * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p, vc.float())
            m_run = m_new
        out = acc / torch.clamp(l_run, min=1e-30)[..., None]
        outs.append(out.to(q.dtype).reshape(B, cq, Hq, D))
    return torch.cat(outs, dim=1)[:, :Tq]


def attention(q, k, v, *, causal=True, window=0, softcap=0.0, prefix_len=0,
              q_offset=0, scale=None, kv_len=None, impl="chunked",
              q_chunk=512, k_chunk=1024):
    if impl == "pallas" and kv_len is None and isinstance(q_offset, int):
        return kattn.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window, softcap=softcap, prefix_len=prefix_len,
            q_offset=q_offset, scale=scale)
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, prefix_len=prefix_len,
                               q_offset=q_offset, scale=scale, kv_len=kv_len)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             softcap=softcap, prefix_len=prefix_len,
                             q_offset=q_offset, scale=scale, kv_len=kv_len,
                             q_chunk=q_chunk, k_chunk=k_chunk)


def cache_update(cache_k, cache_v, k_new, v_new, index: int):
    """Write ``k_new/v_new`` [B, T, Hkv, D] into the cache at ``index``, in
    place; returns the two cache tensors.  As ``lax.dynamic_update_slice``
    does, a negative start counts from the end (``+ L``) and the start is
    then clamped so that the write fits: ``[0, L - T]``."""
    T, L = k_new.shape[1], cache_k.shape[1]
    if T > L:
        raise ValueError(f"cache_update: {T} new positions exceed the cache "
                         f"length {L}")
    start = int(index)
    start = min(max(start + L if start < 0 else start, 0), L - T)
    cache_k[:, start:start + T] = k_new.to(cache_k.dtype)
    cache_v[:, start:start + T] = v_new.to(cache_v.dtype)
    return cache_k, cache_v
