"""Diagonal linear recurrence ``h_t = a_t * h_{t-1} + x_t`` (source:
``csrc/scan.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/ssm.py`` ``linear_scan``.  A
CUDA tensor launches the hand-written kernel (or the wrapper raises); a CPU
tensor runs :func:`linear_scan_plain`, the loop of
``repro/kernels/ref.py`` ``linear_scan_ref``.  Both compute each step as a
rounded product followed by a rounded sum (no fused multiply-add), so the
kernel equals the plain version bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .maxmin import _route, _stream, no_grad_through

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def linear_scan_plain(a, x, h0=None):
    """(y, h_last): every ``h_t`` in ``x``'s dtype and the final state in
    f32.  a, x: [B, T, D]; h0: [B, D] f32 or None (zeros)."""
    B, T, D = x.shape
    h = (x.new_zeros((B, D), dtype=torch.float32) if h0 is None
         else h0.float())
    a32, x32 = a.float(), x.float()
    y = x.new_empty((B, T, D))
    for t in range(T):
        h = a32[:, t] * h + x32[:, t]
        y[:, t] = h
    return y, h


def check_launch_limits(B: int, T: int, D: int) -> None:
    """The kernel's own shape limits: a batch row per grid row (at most
    65535) and B, T, D passed as int32.  Offsets are 64-bit inside, so
    B * T * D is not limited."""
    if B > 65535 or max(T, D) >= 2 ** 31:
        raise ValueError(f"linear_scan: needs B <= 65535 and T, D < 2**31, "
                         f"got B={B}, T={T}, D={D}")


def _lib():
    lib = _build.load("scan")
    if not getattr(lib, "_typed", False):
        lib.linear_scan_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.linear_scan_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def linear_scan(a, x, h0=None):
    """(y, h_last) of the recurrence over axis 1 with an f32 carry.

    a, x: [B, T, D] in f32 or bf16 (each on its own); h0: [B, D] f32 or
    None.  y has x's dtype, h_last is f32.  Raises ``RuntimeError`` on
    either device when grad is enabled and an input requires grad (no
    backward): train through ``attn_impl="chunked"``, which routes Mamba's
    scan too."""
    no_grad_through("linear_scan", a, x, h0)
    if not _route(x, "linear_scan"):
        return linear_scan_plain(a, x, h0)
    if x.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"linear_scan: expected a and x of one shape "
                         f"[B, T, D], got {tuple(a.shape)} and "
                         f"{tuple(x.shape)}")
    B, T, D = x.shape
    if T < 1:
        raise ValueError("linear_scan: T must be at least 1")
    if a.dtype not in _DTYPE_CODE or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"linear_scan: a and x must be f32 or bf16, got "
                        f"{a.dtype} and {x.dtype}")
    tensors = [a, x]
    if h0 is not None:
        if h0.shape != (B, D) or h0.dtype != torch.float32:
            raise ValueError(f"linear_scan: h0 must be f32 [B, D] = "
                             f"{[B, D]}, got {h0.dtype} {tuple(h0.shape)}")
        tensors.append(h0)
    if any(t.device != x.device for t in tensors):
        raise ValueError("linear_scan: inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("linear_scan: inputs must be contiguous")
    check_launch_limits(B, T, D)
    y = torch.empty((B, T, D), dtype=x.dtype, device=x.device)
    h_last = torch.empty((B, D), dtype=torch.float32, device=x.device)
    err = _lib().linear_scan_launch(
        a.data_ptr(), x.data_ptr(), 0 if h0 is None else h0.data_ptr(),
        y.data_ptr(), h_last.data_ptr(), B, T, D, _DTYPE_CODE[a.dtype],
        _DTYPE_CODE[x.dtype], _stream(x.device))
    if err != 0:
        raise RuntimeError(f"linear_scan: kernel launch failed with CUDA "
                           f"error {err}")
    linear_scan.launches += 1
    return y, h_last


linear_scan.launches = 0
