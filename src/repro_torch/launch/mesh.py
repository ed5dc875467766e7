"""Mesh records (port of ``repro/launch/mesh.py``).

A :class:`Mesh` names its axes and their sizes and nothing else: the
sharding rules (:mod:`repro_torch.dist.sharding`) read only its ``shape``.
Making one touches no device and starts no process group.  The port runs
on one device, so only a mesh of one device is run by the dry run; the
production meshes are kept for the rule tables and the records' names.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")

    @property
    def shape(self) -> dict[str, int]:
        """Ordered axis -> size mapping."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """Number of devices."""
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single-pod (256 devices) or 2x16x16 two-pod (512) mesh."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """Arbitrary mesh (tests / hillclimb variants)."""
    return Mesh(tuple(axes), tuple(int(s) for s in shape))


def host_mesh() -> Mesh:
    """Single-device mesh with the production axis names."""
    return Mesh(("data", "model"), (1, 1))
