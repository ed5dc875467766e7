"""Event-horizon reduction: ``min(cand[mask])`` of one vector, or of each
row of a batch (source: ``csrc/horizon.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/horizon.py`` ``masked_min``.
A CUDA tensor launches the hand-written kernel (or the wrapper raises); a
CPU tensor runs the plain PyTorch version, which computes what
``repro/kernels/ref.py`` ``masked_min_ref`` computes.  The result is a 0-d
tensor (a [B] tensor for [B, N] rows, one lane a row) on the input's
device: the engine never reads it back to the host.  One launch serves
every row.  Up to ``SINGLE_BLOCK_LANES`` lanes a row runs one block; a
longer row runs a row of blocks whose ticket and partial minima sit in a
workspace of ``WORKSPACE_BYTES`` a row that the wrapper allocates for that
call alone, so the kernel holds no state between calls.  The source also
holds an empty kernel behind a launch function of the same signature
(``empty_launch``), which ``chip_smoke.py`` times as the launch floor of
this ``ctypes`` path.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .maxmin import MAX_LANES, _route, _stream

BIG = 3.0e38
# csrc/horizon.cu: lanes one block takes, and the grid path's workspace of a
# row (a ticket and one partial minimum for each of at most 264 blocks)
SINGLE_BLOCK_LANES = 65536
WORKSPACE_BYTES = 4 * (1 + 264)


def masked_min_plain(cand: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``min(where(mask, cand, BIG))`` (``ref.masked_min_ref``), of the
    vector or of each row."""
    if cand.dim() == 1:
        return torch.min(torch.where(mask, cand, BIG))
    # row by row: each row's min, its NaN's bits included, is the vector's
    return torch.stack([masked_min_plain(c, m) for c, m in zip(cand, mask)])


def _lib():
    lib = _build.load("horizon")
    if not getattr(lib, "_typed", False):
        for fn in (lib.masked_min_launch, lib.empty_launch):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def masked_min(cand: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``min(cand[mask])``, ``BIG`` (3e38) when the mask is empty: a 0-d
    tensor for a vector [N], a [B] tensor for rows [B, N].  An empty row
    has no minimum: it raises ``ValueError`` on either device."""
    if cand.numel() == 0 or cand.shape[-1] == 0:
        raise ValueError("masked_min: empty input (the min has no identity)")
    if not _route(cand, "masked_min"):
        return masked_min_plain(cand, mask)
    if mask.device != cand.device:
        raise ValueError(f"masked_min: mask is on {mask.device}, cand on "
                         f"{cand.device}")
    if cand.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError(f"masked_min: expected f32 cand and bool mask, got "
                        f"{cand.dtype} and {mask.dtype}")
    if cand.dim() not in (1, 2) or mask.shape != cand.shape:
        raise ValueError(f"masked_min: expected two [N] or two [B, N] "
                         f"tensors of one shape, got {tuple(cand.shape)} and "
                         f"{tuple(mask.shape)}")
    if not (cand.is_contiguous() and mask.is_contiguous()):
        raise ValueError("masked_min: inputs must be contiguous")
    n = cand.shape[-1]
    rows = cand.shape[0] if cand.dim() == 2 else 1
    if n >= 2 ** 31 or rows > MAX_LANES:
        raise ValueError("masked_min: length exceeds int32 indexing or rows "
                         f"exceed {MAX_LANES}")
    out = cand.new_empty(cand.shape[:-1])   # fresh f32 minima on cand's device
    # the grid path's tickets and partials: this call's own workspace
    ws = (cand.new_empty((rows * WORKSPACE_BYTES // 4,))
          if n > SINGLE_BLOCK_LANES else None)
    err = _lib().masked_min_launch(cand.data_ptr(), mask.data_ptr(),
                                   out.data_ptr(),
                                   None if ws is None else ws.data_ptr(), n,
                                   rows, _stream(cand.device))
    if err != 0:
        raise RuntimeError(f"masked_min: kernel launch failed with CUDA "
                           f"error {err}")
    masked_min.launches += 1
    return out


masked_min.launches = 0
