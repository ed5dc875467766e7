"""Event-horizon reduction: scalar ``min(cand[mask])`` (source:
``csrc/horizon.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/horizon.py`` ``masked_min``.
A CUDA tensor launches the hand-written kernel (or the wrapper raises); a
CPU tensor runs the plain PyTorch version, which computes what
``repro/kernels/ref.py`` ``masked_min_ref`` computes.  The result is a 0-d
tensor on the input's device: the engine never reads it back to the host.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .maxmin import _route

BIG = 3.0e38


def masked_min_plain(cand: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``min(where(mask, cand, BIG))`` (``ref.masked_min_ref``)."""
    return torch.min(torch.where(mask, cand, BIG))


def _lib():
    lib = _build.load("horizon")
    if not getattr(lib, "_typed", False):
        lib.masked_min_launch.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_void_p]
        lib.masked_min_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def masked_min(cand: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Scalar ``min(cand[mask])``, ``BIG`` (3e38) when the mask is empty."""
    if not _route(cand, "masked_min"):
        return masked_min_plain(cand, mask)
    if mask.device != cand.device:
        raise ValueError(f"masked_min: mask is on {mask.device}, cand on "
                         f"{cand.device}")
    if cand.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError(f"masked_min: expected f32 cand and bool mask, got "
                        f"{cand.dtype} and {mask.dtype}")
    if cand.dim() != 1 or mask.shape != cand.shape:
        raise ValueError(f"masked_min: expected two 1-D tensors of one "
                         f"length, got {tuple(cand.shape)} and "
                         f"{tuple(mask.shape)}")
    if not (cand.is_contiguous() and mask.is_contiguous()):
        raise ValueError("masked_min: inputs must be contiguous")
    n = cand.shape[0]
    if n >= 2 ** 31:
        raise ValueError("masked_min: length exceeds int32 indexing")
    out = torch.empty((), dtype=torch.float32, device=cand.device)
    err = _lib().masked_min_launch(
        cand.data_ptr(), mask.data_ptr(), out.data_ptr(), n,
        torch.cuda.current_stream(cand.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"masked_min: kernel launch failed with CUDA "
                           f"error {err}")
    masked_min.launches += 1
    return out


masked_min.launches = 0
