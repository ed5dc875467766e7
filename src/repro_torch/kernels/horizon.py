"""Event-horizon reduction: scalar ``min(cand[mask])`` (source:
``csrc/horizon.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/horizon.py`` ``masked_min``.
A CUDA tensor launches the hand-written kernel (or the wrapper raises); a
CPU tensor runs the plain PyTorch version, which computes what
``repro/kernels/ref.py`` ``masked_min_ref`` computes.  The result is a 0-d
tensor on the input's device: the engine never reads it back to the host.
Up to ``SINGLE_BLOCK_LANES`` lanes the kernel runs one block; a longer
vector runs a grid whose ticket and partial minima sit in a workspace of
``WORKSPACE_BYTES`` that the wrapper allocates for that call alone, so the
kernel holds no state between calls.  The source also holds an empty kernel
behind a launch function of the same signature (``empty_launch``), which
``chip_smoke.py`` times as the launch floor of this ``ctypes`` path.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .maxmin import _route, _stream

BIG = 3.0e38
# csrc/horizon.cu: lanes one block takes, and the grid path's workspace (a
# ticket and one partial minimum for each of at most 264 blocks)
SINGLE_BLOCK_LANES = 65536
WORKSPACE_BYTES = 4 * (1 + 264)


def masked_min_plain(cand: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``min(where(mask, cand, BIG))`` (``ref.masked_min_ref``)."""
    return torch.min(torch.where(mask, cand, BIG))


def _lib():
    lib = _build.load("horizon")
    if not getattr(lib, "_typed", False):
        for fn in (lib.masked_min_launch, lib.empty_launch):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def masked_min(cand: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Scalar ``min(cand[mask])``, ``BIG`` (3e38) when the mask is empty.
    An empty vector has no minimum: it raises ``ValueError`` on either
    device."""
    if cand.numel() == 0:
        raise ValueError("masked_min: empty input (the min has no identity)")
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
    out = cand.new_empty(())   # a fresh f32 scalar on cand's device
    # the grid path's ticket and partials: this call's own workspace
    ws = (cand.new_empty((WORKSPACE_BYTES // 4,))
          if n > SINGLE_BLOCK_LANES else None)
    err = _lib().masked_min_launch(cand.data_ptr(), mask.data_ptr(),
                                   out.data_ptr(),
                                   None if ws is None else ws.data_ptr(), n,
                                   _stream(cand.device))
    if err != 0:
        raise RuntimeError(f"masked_min: kernel launch failed with CUDA "
                           f"error {err}")
    masked_min.launches += 1
    return out


masked_min.launches = 0
