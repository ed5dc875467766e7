"""Block-wise (flash) attention (sources: ``csrc/attention.cu``,
``csrc/attention_wgmma.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/attention.py``
``flash_attention``.  A CUDA tensor launches a hand-written kernel (or the
wrapper raises): bf16 with D = 64 or 128 the Hopper kernel (TMA, wgmma,
warp-specialised warpgroups), bf16 with any other D the ``mma.sync``
tensor-core kernel, f32 the CUDA-core one, each with its own tile shape
(:func:`variant`).  A CPU tensor runs
:func:`flash_attention_plain`, the materialised softmax of
``repro/kernels/ref.py`` ``attention_ref``.

Masks follow that oracle, which ``models/attention._mask`` matches on every
case a model reaches.  The Pallas kernel departs from it in two corners
(ROADMAP queue 3): it drops prefix keys beyond the q tile when
``prefix_len`` exceeds its KV block, and it applies no per-element window
mask without ``causal``.  The kernel here keeps every tile that holds
prefix keys, and the wrapper refuses ``causal=False`` with ``window > 0``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .maxmin import _route, _stream, no_grad_through

NEG = -1e30
BQ, BK = 64, 32          # the f32 (CUDA-core) kernel's q and KV tile heights
WGMMA_D = (64, 128)      # the bf16 head dims of the wgmma kernel


class Variant(NamedTuple):
    """One flash kernel and its tile shape."""
    name: str            # "wgmma" (bf16, Hopper), "mma" (bf16, mma.sync)
    #                      or "f32" (CUDA cores)
    bq: int              # q rows per block
    bk: int              # keys per KV tile


MMA = Variant("mma", 64, 32)
WGMMA = Variant("wgmma", 128, 128)


def variant(dtype, D: int) -> Variant:
    """The kernel that takes inputs of ``dtype`` with head dim ``D``: bf16
    with D = 64 or 128 the wgmma kernel (128 q rows, two consumer
    warpgroups, by 128-key tiles); bf16 with any other D the mma.sync
    kernel (D padded in shared memory to 16, 32, 64, 128 or 256; 64 rows by
    32 keys, measured best of 64 or 128 rows by 32 or 64 keys); f32 the
    CUDA-core kernel (64 rows by 32 keys).  Raises for D outside [1, 256]
    and for any other dtype."""
    if not 1 <= D <= 256:
        raise ValueError(f"flash_attention: needs 1 <= D <= 256, got D={D}")
    if dtype == torch.bfloat16:
        return WGMMA if D in WGMMA_D else MMA
    if dtype == torch.float32:
        return Variant("f32", BQ, BK)
    raise TypeError(f"flash_attention: no kernel for dtype {dtype} "
                    f"(f32 or bf16)")


def flash_attention_plain(q, k, v, *, causal=True, window=0, softcap=0.0,
                          prefix_len=0, q_offset=0, scale=None):
    """``ref.attention_ref``: [B,Tq,Hq,D] x [B,Tk,Hkv,D] -> q's shape and
    dtype, f32 softmax over the whole score matrix."""
    B, Tq, Hq, D = q.shape
    _, Tk, Hkv, _ = k.shape
    g = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale
    qr = q.reshape(B, Tq, Hkv, g, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qr.float(), k.float()) * scale
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(Tq, device=q.device) + q_offset
    kpos = torch.arange(Tk, device=q.device)
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask = kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    if prefix_len > 0:
        mask = mask | (kpos[None, :] < prefix_len)
    logits = torch.where(mask, logits, NEG)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Tq, Hq, D).to(q.dtype)


def visited_tiles(Tq, Tk, *, causal=True, window=0, prefix_len=0,
                  q_offset=0, bq=BQ, bk=BK) -> int:
    """KV tiles one (batch, head) visits with ``bq`` x ``bk`` tiles (a
    variant's ``bq, bk``): the kernels' skip rule, counted on the host (a
    tile is visited iff some key in it is visible to some row of the q tile;
    a tile that holds prefix keys is always visited)."""
    n = 0
    for q0 in range(0, Tq, bq):
        qp0, qp1 = q_offset + q0, q_offset + min(q0 + bq, Tq) - 1
        for k0 in range(0, Tk, bk):
            k_last = min(k0 + bk, Tk) - 1
            n += (not causal or (prefix_len > 0 and k0 < prefix_len)
                  or (k0 <= qp1 and (window <= 0 or k_last > qp0 - window)))
    return n


def check_launch_limits(B: int, Tq: int, Tk: int, Hq: int, D: int, *,
                        window: int = 0, prefix_len: int = 0,
                        q_offset: int = 0, dtype=torch.float32,
                        var: Variant | None = None) -> None:
    """The shape limits of the kernel that takes ``dtype``.  The f32 kernel's
    grid is (q tiles, B * Hq): at most 65535 rows of (batch, q head).  Both
    bf16 kernels' grids are (B * Hq, q tiles): at most 65535 q tiles of the
    variant's ``bq`` rows (64 for mma.sync, 128 for wgmma, whose tensor
    maps take any such T).  All need 1 <= D <= 256, Tq, Tk >= 1, and
    positions (up to ``q_offset + Tq``) and mask sizes in int32.  ``var``
    names a bf16 kernel other than :func:`variant`'s choice.  Offsets are
    64-bit inside, so the tensors' sizes are not limited."""
    if dtype == torch.bfloat16:
        bq = (var or variant(dtype, D)).bq if 1 <= D <= 256 else BQ
        if (B * Hq >= 2 ** 31 or -(-Tq // bq) > 65535 or not 1 <= D <= 256
                or Tk < 1 or Tq < 1):
            raise ValueError(
                f"flash_attention: needs ceil(Tq / {bq}) <= 65535, "
                f"B * Hq < 2**31, D <= 256 and Tq, Tk >= 1, got B={B}, "
                f"Hq={Hq}, D={D}, Tq={Tq}, Tk={Tk}")
    elif B * Hq > 65535 or not 1 <= D <= 256 or Tk < 1 or Tq < 1:
        raise ValueError(f"flash_attention: needs B * Hq <= 65535, D <= 256 "
                         f"and Tq, Tk >= 1, got B={B}, Hq={Hq}, D={D}, "
                         f"Tq={Tq}, Tk={Tk}")
    if max(q_offset + Tq, Tk, window, prefix_len) >= 2 ** 31:
        raise ValueError("flash_attention: positions must fit in int32")


# the library and C entry point of each variant
_ENTRY = {"f32": ("attention", "flash_attention_f32_launch"),
          "mma": ("attention", "flash_attention_bf16_launch"),
          "wgmma": ("attention_wgmma", "flash_attention_wgmma_launch")}


def _entry(name: str):
    source, symbol = _ENTRY[name]
    fn = getattr(_build.load(source), symbol)
    if not getattr(fn, "_typed", False):
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn._typed = True
    return fn


def wgmma_smem_bytes(D: int) -> int:
    """Dynamic shared memory of one block of the wgmma kernel at head dim
    ``D`` (64 or 128), in bytes, as its library computes it."""
    fn = _build.load("attention_wgmma").flash_attention_wgmma_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(D)


def _check(q, k, v, causal, window):
    if not causal and window > 0:
        raise ValueError("flash_attention: a sliding window needs "
                         "causal=True (the oracle and the model's mask "
                         "disagree without it)")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: expected q [B,Tq,Hq,D] and k, v "
                         f"[B,Tk,Hkv,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Tq, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[2]:
        raise ValueError(f"flash_attention: k/v shape {tuple(k.shape)} does "
                         f"not fit q shape {tuple(q.shape)}")


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    prefix_len=0, q_offset=0, scale=None, visited=None):
    """Attention of q [B,Tq,Hq,D] over k, v [B,Tk,Hkv,D] (KV head = q head
    // (Hq/Hkv)), output in q's dtype.  ``q_offset`` is the absolute position
    of q[:, 0].  On CUDA, bf16 inputs launch the wgmma kernel (D = 64 or
    128) or the mma.sync kernel (any other D), f32 inputs the CUDA-core one
    (:func:`variant`); every launch counts in
    ``flash_attention.launches``, the bf16 ones also in ``.wgmma_launches``
    or ``.mma_launches``.  ``visited``, an int32 CUDA tensor of
    ``B*Hq*ceil(Tq/bq)`` entries (the variant's ``bq``), receives each
    block's count of visited KV tiles.

    The kernel has no backward (nor has the reference's), so the wrapper
    raises ``RuntimeError`` on either device when grad is enabled and an
    input requires grad: train through ``attn_impl="chunked"``."""
    no_grad_through("flash_attention", q, k, v)
    _check(q, k, v, causal, window)
    if not _route(q, "flash_attention"):
        return flash_attention_plain(
            q, k, v, causal=causal, window=window, softcap=softcap,
            prefix_len=prefix_len, q_offset=q_offset, scale=scale)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share f32 or bf16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    return _launch(variant(q.dtype, q.shape[3]), q, k, v, causal=causal,
                   window=window, softcap=softcap, prefix_len=prefix_len,
                   q_offset=q_offset, scale=scale, visited=visited)


def _launch(var: Variant, q, k, v, *, causal=True, window=0, softcap=0.0,
            prefix_len=0, q_offset=0, scale=None, visited=None):
    """Launch the kernel of ``var`` on CUDA tensors q, k, v that
    :func:`flash_attention` has checked.  ``flash_attention`` passes
    :func:`variant`'s choice; chip_smoke.py also holds the mma.sync kernel
    at D = 64 and 128 by passing :data:`MMA`."""
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if (var.name == "f32") != (q.dtype == torch.float32) or (
            q.dtype not in (torch.float32, torch.bfloat16)):
        raise TypeError(f"flash_attention: the {var.name} kernel does not "
                        f"take {q.dtype}")
    if var.name == "wgmma" and D not in WGMMA_D:
        raise ValueError(f"flash_attention: the wgmma kernel takes D = 64 "
                         f"or 128, got D={D}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("flash_attention: inputs lie on different devices")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: inputs must be contiguous")
    if var.name == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        # TMA reads from 16-byte aligned bases; the rows (Hq * D * 2 bytes)
        # are multiples of 16 at D = 64 and 128
        raise ValueError("flash_attention: the wgmma kernel needs q, k and "
                         "v at 16-byte aligned addresses (TMA)")
    check_launch_limits(B, Tq, Tk, Hq, D, window=window,
                        prefix_len=prefix_len, q_offset=q_offset,
                        dtype=q.dtype, var=var)
    n_blocks = B * Hq * -(-Tq // var.bq)
    if visited is not None and (visited.dtype != torch.int32
                                or visited.numel() != n_blocks
                                or visited.device != q.device):
        raise ValueError(f"flash_attention: visited must be int32 with "
                         f"{n_blocks} entries on {q.device}")
    scale = float(D ** -0.5) if scale is None else float(scale)
    out = torch.empty_like(q)
    err = _entry(var.name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        0 if visited is None else visited.data_ptr(), B, Tq, Tk, Hq, Hkv, D,
        scale, float(softcap), int(bool(causal)), int(window),
        int(prefix_len), int(q_offset), _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    if var.name == "mma":
        flash_attention.mma_launches += 1
    elif var.name == "wgmma":
        flash_attention.wgmma_launches += 1
    return out


flash_attention.launches = 0
flash_attention.mma_launches = 0
flash_attention.wgmma_launches = 0
