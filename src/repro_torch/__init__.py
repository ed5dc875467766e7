"""PyTorch/CUDA port of the DISSECT-CF IaaS simulator.

Module paths mirror the JAX package ``repro``: ``repro_torch.core.loop.advance``
answers to ``repro.core.loop.advance``.  The port imports ``torch`` and numpy
only.  Its entry points run on the GPU unless the caller passes
``device="cpu"``; on a CUDA tensor every kernel wrapper in
:mod:`repro_torch.kernels` launches its hand-written kernel, on a CPU tensor
it runs the kernel's plain PyTorch version.
"""
from .device import resolve_device  # noqa: F401
