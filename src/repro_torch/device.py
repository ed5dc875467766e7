"""Device selection for the port's entry points.

The entry points (``simulate``, ``init_state``, the kernel wrappers' callers)
run on the GPU unless the caller asks for the CPU.  Without a card and without
``device="cpu"`` they raise instead of quietly running somewhere else.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means the GPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           f"available")
    return dev


def match_xla_matmul() -> None:
    """Make CUDA products accumulate as XLA's do: f32 products in full f32
    (no TF32, in matmuls or cuDNN) and bf16 products with f32 reductions.
    These are process-wide PyTorch settings; the LM entry points set them
    on each call on the card (:func:`match_xla_matmul_on`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def match_xla_matmul_on(device) -> None:
    """:func:`match_xla_matmul` when ``device`` is a CUDA device."""
    if torch.device(device).type == "cuda":
        match_xla_matmul()
