"""Operation-count cost analysis of an eager PyTorch program (the port's
counterpart of ``repro/launch/hlo_cost.py``).

The reference walks XLA's optimized HLO text, multiplying each ``while``
body by its trip count.  PyTorch has no HLO: the port runs the program once
under a :class:`~torch.utils._python_dispatch.TorchDispatchMode` and counts
every aten op that reaches the dispatcher (after autograd and the composite
ops such as ``einsum``, ``matmul`` and ``linear`` have decomposed).  Eager
execution runs every trip of every loop, so there is no trip count to
parse.  The mode works on ``meta`` tensors (shapes and dtypes, no storage:
a dry run) as on real ones, and counts the same ops on both.

* **dot_flops**: ``2 * prod(output) * prod(contracted dims)`` for each
  ``mm``, ``addmm``, ``bmm``, ``baddbmm`` and ``convolution``, the rule of
  ``hlo_cost``;
* **elem_flops**: ``prod(output)`` for each op tagged pointwise;
* **bytes_accessed**: input plus output bytes of each op that is not a view.
  That is the eager port's own traffic: it fuses nothing, so it moves more
  than XLA's count of a fused program;
* **collectives**: the operand bytes and the count of each functional
  collective (``_c10d_functional``: ``all_gather_into_tensor``,
  ``reduce_scatter_tensor``, ``all_reduce``, ``all_to_all_single``) under
  the reference's kinds (``all-gather``, ``reduce-scatter``,
  ``all-reduce``, ``all-to-all``), as ``hlo_cost`` sums each HLO
  collective's operands; zero on one device;
* **peak_bytes**: the most bytes of storage, made by the program's ops, that
  were alive at once (the arguments not counted).  A storage counts from
  the op that made it until it is freed (a finalizer on its storage object,
  which lives as long as the storage does, views and autograd's saved
  tensors included).

On a mesh the program's tensors are DTensors (``dist.sharding``) and the
counter counts what one rank runs: an op on DTensors is left to DTensor,
which runs it on the local shards, and those local ops are counted, at
their local shapes, with the collectives its redistributions issue.
DTensor's sharding propagation also runs an op once on global-shape fake
tensors the first time it meets that op's schema (it caches the result):
ops on fake tensors, or that make them, are not counted, so the count
does not depend on the state of that cache.  Sizes (the arguments', the outputs', the peak) are
of the local shards.

``analyze(fn, *args)`` returns the reference's keys; :func:`breakdown`
ranks the aten ops by the same weighting as the reference's.
"""
from __future__ import annotations

import collections
import math
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

from ..dist import sharding as shd

aten = torch.ops.aten

# functional collectives -> the reference's HLO collective kinds
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}

# product ops: the operand whose last dim is contracted
_DOT_LHS = {aten.mm.default: 0, aten.addmm.default: 1, aten.bmm.default: 0,
            aten.baddbmm.default: 1}


def _tensors(tree, out=None) -> list:
    """The tensor leaves of nested tuples, lists and dicts, in order (a
    DTensor as its local shard)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(shd.local(tree))
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_nbytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree``."""
    return sum(map(_nbytes, _tensors(tree)))


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _dot_flops(func, args, out) -> float:
    if func in _DOT_LHS:
        return 2.0 * out.numel() * args[_DOT_LHS[func]].shape[-1]
    if func == aten.convolution.default:
        x, w, transposed = args[0], args[1], args[6]
        # each output element (each input element when transposed) meets
        # prod(weight.shape[1:]) weights
        return 2.0 * (x if transposed else out).numel() * math.prod(
            w.shape[1:])
    return 0.0


def _describe(x):
    """A hashable key of one argument: a tensor by its metadata, a list
    element-wise, anything else (a number, a dtype) by its type and value
    (``1`` and ``1.0`` promote differently)."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.device)
    if isinstance(x, (list, tuple)):
        return tuple(map(_describe, x))
    return type(x), x


def _meta_call(cache: dict, func, info, tensors, args, kwargs):
    """``func(*args, **kwargs)``; on ``meta`` tensors a functional op (one
    that writes no input and returns no view) is answered from the outputs
    the meta kernel gave for the same op on the same shapes, strides and
    dtypes.  A meta kernel is a function of those alone, so the result is
    the kernel's own; PyTorch's meta kernels for pointwise ops run in
    Python (~300 us an op), and a dry run repeats each op of a chunk loop
    on the same shapes thousands of times.  ``cache`` maps an op and its
    arguments' metadata to its outputs' (shape, stride, dtype)."""
    if (not info.functional or not tensors
            or tensors[0].device.type != "meta"):
        return func(*args, **kwargs)
    try:
        key = (func, _describe(args), _describe(tuple(kwargs.items())))
        spec = cache.get(key)
    except TypeError:           # an unhashable argument
        return func(*args, **kwargs)
    if spec is None:
        out = func(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            cache[key] = (out.shape, out.stride(), out.dtype)
        elif (isinstance(out, (tuple, list))
              and all(isinstance(t, torch.Tensor) for t in out)):
            cache[key] = (type(out), [(t.shape, t.stride(), t.dtype)
                                      for t in out])
        return out

    def make(shape, stride, dtype):
        return torch.empty_strided(shape, stride, dtype=dtype, device="meta")

    if len(spec) == 3:
        return make(*spec)
    kind, outs = spec
    return kind(make(*s) for s in outs)


class _OpInfo:
    """What the counter needs of an op, read once from its schema."""

    def __init__(self, func):
        schema = func._schema
        self.name = func.overloadpacket.__name__
        self.is_view = func.is_view
        self.pointwise = torch.Tag.pointwise in func.tags
        self.written = [i for i, a in enumerate(schema.arguments)
                        if a.alias_info is not None and a.alias_info.is_write]
        self.functional = not schema.is_mutable and all(
            r.alias_info is None for r in schema.returns)


_OP_INFO: dict = {}


class OpCount(TorchDispatchMode):
    """Counts the aten ops run inside it (module docstring).  Use as
    ``with OpCount(args) as c: fn(*args)``; ``args`` are the program's
    inputs, whose storages are not counted towards the peak and whose
    in-place writes are summed in :attr:`aliased_bytes`."""

    def __init__(self, args=()):
        super().__init__()
        self.dot_flops = 0.0
        self.elem_flops = 0.0
        self.bytes_accessed = 0.0
        self.by_op = collections.defaultdict(
            lambda: {"calls": 0, "dot_flops": 0.0, "elem_flops": 0.0,
                     "bytes": 0.0})
        # the arguments, held so that their storages' keys stay theirs
        self._args = {_storage_key(t): t for t in _tensors(args)}
        self._written = {}
        self._live = {}            # storage key -> (finalizer, bytes)
        self._meta_outputs = {}    # see _meta_call
        self.live_bytes = 0
        self.peak_bytes = 0
        self.collective_bytes = collections.Counter()
        self.collective_counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(shd.is_dtensor_type(t) for t in types):
            return NotImplemented       # DTensor runs it on local shards
        ins = _tensors(args, _tensors(kwargs))
        if any(isinstance(t, FakeTensor) for t in ins):
            return func(*args, **kwargs)    # DTensor's global-shape trial
        if func.namespace == "_c10d_functional":
            kind = COLLECTIVE_KINDS.get(func.overloadpacket.__name__)
            if kind is not None:
                self.collective_bytes[kind] += sum(map(_nbytes, ins))
                self.collective_counts[kind] += 1
            return func(*args, **kwargs)
        info = _OP_INFO.get(func)
        if info is None:
            info = _OP_INFO[func] = _OpInfo(func)
        out = _meta_call(self._meta_outputs, func, info, ins, args, kwargs)
        outs = _tensors(out)
        if not ins and any(isinstance(t, FakeTensor) for t in outs):
            return out          # a factory op of the same trial
        row = self.by_op[info.name]
        row["calls"] += 1
        if info.is_view:
            return out
        moved = float(sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)))
        dots = _dot_flops(func, args, outs[0]) if outs else 0.0
        elems = float(outs[0].numel()) if outs and info.pointwise else 0.0
        self.bytes_accessed += moved
        self.dot_flops += dots
        self.elem_flops += elems
        row["bytes"] += moved
        row["dot_flops"] += dots
        row["elem_flops"] += elems
        for i in info.written:
            if i < len(args) and isinstance(args[i], torch.Tensor):
                key = _storage_key(args[i])
                if key in self._args:
                    self._written[key] = args[i].untyped_storage().nbytes()
        for t in outs:
            self._track(t)
        return out

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._args or key in self._live:
            return
        n = st.nbytes()
        self._live[key] = (weakref.finalize(st, self._free, key), n)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key: int):
        _, n = self._live.pop(key)
        self.live_bytes -= n

    def __exit__(self, *exc):
        for fin, _ in self._live.values():
            fin.detach()
        self._live.clear()
        return super().__exit__(*exc)

    @property
    def aliased_bytes(self) -> int:
        """Bytes of the argument storages that the program wrote in place."""
        return sum(self._written.values())

    def summary(self) -> dict:
        """The reference's ``hlo_cost.analyze`` keys, and the peak."""
        return {
            "dot_flops": self.dot_flops,
            "elem_flops": self.elem_flops,
            "flops": self.dot_flops + self.elem_flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": {k: float(v) for k, v in
                                 self.collective_bytes.items()},
            "collective_counts": {k: float(v) for k, v in
                                  self.collective_counts.items()},
            "collective_total_bytes": float(
                sum(self.collective_bytes.values())),
            "while_trips": [],
            "n_ops": sum(r["calls"] for r in self.by_op.values()),
            "peak_bytes": self.peak_bytes,
        }

    def breakdown(self, top_n: int = 25) -> list[dict]:
        """The ``top_n`` aten ops by ``bytes + flops / 240`` (the
        reference's weighting), each with its calls, FLOPs and bytes."""
        rows = [dict(op=name, calls=r["calls"], bytes=r["bytes"],
                     dot_flops=r["dot_flops"],
                     flops=r["dot_flops"] + r["elem_flops"])
                for name, r in self.by_op.items()]
        return sorted(rows, key=lambda r: -(r["bytes"] + r["flops"] / 240.0)
                      )[:top_n]


def count(fn, *args) -> tuple[object, OpCount]:
    """Run ``fn(*args)`` under an :class:`OpCount`; returns (its result,
    the counter)."""
    with OpCount(args) as c:
        out = fn(*args)
    return out, c


def analyze(fn, *args) -> dict:
    """Counts of one run of ``fn(*args)`` (module docstring)."""
    return count(fn, *args)[1].summary()


def breakdown(fn, *args, top_n: int = 25) -> list[dict]:
    """The ``top_n`` aten ops of one run of ``fn(*args)``."""
    return count(fn, *args)[1].breakdown(top_n)
