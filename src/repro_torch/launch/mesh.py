"""Mesh records and the process groups that run them (port of
``repro/launch/mesh.py``).

A :class:`Mesh` names its axes and their sizes and nothing else: the
sharding rules (:mod:`repro_torch.dist.sharding`) read only its ``shape``.
Making one touches no device and starts no process group.  To run on it,
start a process group of ``mesh.size`` ranks (:func:`init_from_env` for
real ranks, NCCL on the card and ``gloo`` on the CPU; :func:`init_fake` for
the dry run, one process standing in for every rank) and build the
:class:`~torch.distributed.device_mesh.DeviceMesh` with
:func:`device_mesh`.
"""
from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist


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


def parse_mesh(text: str) -> Mesh:
    """``"AxB"`` / ``"AxBxC"`` as a mesh whose axes are the last of
    ``("pod", "data", "model")``, the reference launcher's naming."""
    dims = tuple(int(x) for x in text.split("x"))
    if not 1 <= len(dims) <= 3:
        raise ValueError(f"mesh {text!r}: one to three sizes")
    return make_mesh(dims, ("pod", "data", "model")[-len(dims):])


def _check_world(mesh: Mesh) -> None:
    world = dist.get_world_size()
    if world != mesh.size:
        raise ValueError(f"mesh {mesh.shape} has {mesh.size} devices and "
                         f"the process group {world} ranks")


def init_from_env(device=None) -> torch.device:
    """Start the default process group from ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` (what ``torchrun`` sets) and return
    this rank's device: ``cuda:LOCAL_RANK`` with NCCL, or the CPU with
    ``gloo`` when ``device`` is ``"cpu"``.  A group already started is
    kept.  Without a card and without ``device="cpu"`` it raises."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if cpu:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a mesh runs on CUDA devices by default and none is "
                "available; pass device='cpu' to run on gloo ranks")
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch has no NCCL backend")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("gloo" if cpu else "nccl",
                                device_id=None if cpu else dev)
    return dev


def init_fake(mesh: Mesh, rank: int = 0) -> None:
    """Start a fake process group of ``mesh.size`` ranks in this process
    (its collectives move nothing): the dry run's stand-in for the mesh.
    Ends any group already started."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=mesh.size)


def device_mesh(mesh: Mesh, device=None):
    """The :class:`~torch.distributed.device_mesh.DeviceMesh` of ``mesh``
    over the started process group, on CUDA unless ``device`` is
    ``"cpu"`` or ``"meta"`` (the latter two need no card).  The group must
    have ``mesh.size`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    kind = "cuda" if device is None else torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a mesh runs on CUDA devices by default and none is "
            "available; pass device='cpu'")
    if kind == "meta":
        kind = "cpu"
    if not dist.is_initialized():
        raise RuntimeError(f"mesh {mesh.shape}: no process group started "
                           f"(init_from_env or init_fake)")
    _check_world(mesh)
    return init_device_mesh(kind, mesh.axis_sizes,
                            mesh_dim_names=mesh.axis_names)
