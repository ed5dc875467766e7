"""Checkpointing: atomic, async, restore onto any device or mesh (port of
``repro/train/ckpt.py``).

* **Atomic** — the state is written to ``step_XXXXXXXX.npz.tmp`` and
  ``os.replace``d into place, so a crash mid-write never corrupts the
  latest checkpoint; the ``LATEST`` marker is updated after the rename.
* **Async** — :meth:`Checkpointer.save_async` copies every leaf to host
  memory before it returns and writes on a daemon thread, overlapping the
  write with the next training steps; :meth:`Checkpointer.wait` joins it.
* **Restore onto a device or a mesh** — :meth:`Checkpointer.restore`
  takes a target tree (real or ``meta`` tensors) and an optional device,
  or the target's shardings (``dist.sharding.tree_shardings``), as the
  reference does: each leaf lands on its placements on any mesh, whatever
  mesh wrote it (the elastic reshard).
* **Sharded states** — saving a state of DTensors gathers each leaf on
  every rank (a collective: every rank calls ``save``); one rank writes
  the file the one-device save writes, and the others wait for it at a
  barrier.
* **Self-describing** — leaves are stored flat under path-joined keys
  (``params/blocks/0/attn/wq``, ``opt/step``, ``opt/m/...``), the
  reference's, so a checkpoint written by either package restores in the
  other.  bf16 leaves are stored as f32 (numpy has no bf16) and cast back
  to the target's dtype on restore.
"""
from __future__ import annotations

import os
import threading
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..dist import sharding as shd
from ..models import common as cm

_SEP = "/"


def _host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` that later in-place updates do not reach."""
    t = shd.full(t.detach())
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


def _flatten(tree) -> dict[str, np.ndarray]:
    return {_SEP.join(path): _host(t) for path, t in cm.leaves(tree)}


def _sharded(tree) -> bool:
    return any(shd.is_dtensor(t) for _, t in cm.leaves(tree))


class Checkpointer:
    def __init__(self, directory: str | Path, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._barrier = False       # a sharded save waits at a barrier

    # ------------------------------------------------------------------ save
    def save(self, state, step: int) -> Path:
        """Synchronous atomic save (after any save in flight)."""
        self.save_async(state, step)
        self.wait()
        return self.dir / f"step_{step:08d}.npz"

    def save_async(self, state, step: int) -> None:
        """Snapshot to host memory now, write in the background (on rank
        0 alone for a sharded state)."""
        self.wait()
        flat = _flatten(state)  # device->host copy (and gather) happens here
        self._barrier = _sharded(state) and dist.get_world_size() > 1
        if self._barrier and dist.get_rank() != 0:
            return
        self._thread = threading.Thread(
            target=self._write, args=(flat, step), daemon=True)
        self._thread.start()

    def wait(self, barrier: bool = True) -> None:
        """Until the save in flight is written (on every rank; with
        ``barrier=False`` only this rank's write is joined, for a rank
        that fails while the others may be inside a step)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier and barrier:
            dist.barrier()
            self._barrier = False

    def _write(self, flat: dict, step: int) -> Path:
        path = self.dir / f"step_{step:08d}.npz"
        tmp = path.with_suffix(".npz.tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
        marker = self.dir / "LATEST"
        marker_tmp = self.dir / "LATEST.tmp"
        marker_tmp.write_text(f"{step}\n")
        os.replace(marker_tmp, marker)
        self._gc()
        return path

    def _gc(self) -> None:
        ckpts = sorted(self.dir.glob("step_*.npz"))
        for old in ckpts[:-self.keep]:
            try:
                old.unlink()
            except OSError:
                pass

    # --------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        marker = self.dir / "LATEST"
        if not marker.exists():
            steps = sorted(self.dir.glob("step_*.npz"))
            if not steps:
                return None
            return int(steps[-1].stem.split("_")[1])
        return int(marker.read_text().strip())

    def restore(self, target, *, step: int | None = None, device=None,
                shardings=None):
        """(the checkpoint in ``target``'s structure and dtypes, its step).

        ``target`` holds real or ``meta`` tensors; keys of the file that it
        lacks are ignored.  With ``shardings`` (``target``'s nesting of
        ``(DeviceMesh, placements)``, as ``dist.sharding.tree_shardings``
        gives) each leaf becomes a DTensor on them, a leaf read at a time;
        else it lands on ``device``, or without one on its target leaf's
        device (a ``meta`` leaf: on the GPU, which raises without a
        card)."""
        if shardings is not None and device is not None:
            raise ValueError("restore takes a device or shardings, not both")
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = self.dir / f"step_{step:08d}.npz"

        def load(path_t, leaf):
            key = _SEP.join(path_t)
            if key not in names:
                raise KeyError(f"checkpoint missing leaf {key}")
            if shardings is not None:
                t = torch.from_numpy(zf[key]).to(dtype=leaf.dtype)
                return shd.distribute({"x": t},
                                      {"x": placed[path_t]})["x"]
            dev = (resolve_device(device) if device is not None
                   or leaf.is_meta else leaf.device)
            return torch.from_numpy(zf[key]).to(device=dev, dtype=leaf.dtype)

        placed = shd.flat_specs(shardings) if shardings is not None else {}

        with np.load(path) as zf:       # reads only the target's leaves
            names = set(zf.files)
            return cm.tree_map(load, target), step
