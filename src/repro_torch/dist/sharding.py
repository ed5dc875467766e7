"""Logical-axis sharding rules: named tensor dims -> mesh axes (port of
``repro/dist/sharding.py``), as plain Python over a mesh's shape.

Model code annotates tensors with *logical* axis names (``batch``,
``embed``, ``mlp``, ``kv_heads``, ``cache_seq`` ...); this module resolves
them against a mesh through a *rule set*: an ordered preference list of
mesh axes per logical name.  Resolution is greedy and safe:

* a mesh axis is never used twice within one tensor's spec;
* an axis is only taken when it (cumulatively) divides the dimension;
  indivisible dims fall back to replication instead of erroring;
* size-1 mesh axes are skipped (they would shard nothing);
* *fallback* names (``cache_seq``) are resolved after all other dims, so
  they only pick up mesh axes the primary dims left free.

A partition spec is a plain tuple with one entry a dimension: a mesh-axis
name, a tuple of names, or ``None`` (replicated).  Only ``mesh.shape`` (an
ordered axis -> size mapping) is read, so the port's
:class:`repro_torch.launch.mesh.Mesh` and the reference's meshes both
serve.

On a mesh of more than one device the specs become DTensor placements
(:func:`placements`, :func:`tree_shardings`) over a
:class:`~torch.distributed.device_mesh.DeviceMesh`: a mesh axis that a
tensor dim names shards that dim, an axis no dim names replicates.
:func:`distribute` places a tree on them, and :func:`constrain` pins an
activation to its logical spec inside :func:`act_ctx`, where the
reference lowers ``with_sharding_constraint`` (the identity outside it,
and on a plain tensor, so one-device code is unchanged).

One dim sharded over several mesh axes is split in mesh-axis order by
DTensor, where the reference splits it in the spec's order.  The two agree
for ``batch`` (``("pod", "data")``, the mesh's order) and differ for
``SERVE_RULES["cache_seq"] = ("model", "data")``: the local shapes and
the collectives' sizes are the same, but device ``(d, m)`` holds the
KV cache's sequence chunk ``d * model + m`` where the reference's holds
``m * data + d``.  The global tensor, and every number computed from it, is
the same; only a per-device dump of such a cache would differ.

Two rule sets ship: :data:`TRAIN_RULES` (FSDP over ``data`` + TP over
``model``) and :data:`SERVE_RULES` (weights replicated over ``data``, TP
over ``model``, long-context KV-cache sequence sharding).
"""
from __future__ import annotations

import collections
import contextlib
import math
import threading
from typing import Any, Mapping, Sequence

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import compute_global_tensor_info
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

from ..models import common as cm

# Logical name -> ordered mesh-axis preferences.
TRAIN_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "embed": ("data",),          # FSDP: shard params over the data axis
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "q_heads": ("model",),
    "kv_heads": ("model",),
    "head": (),
    "seq": (),
    "cache_seq": (),
}

SERVE_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "embed": (),                 # no FSDP at serve time: weights stay local
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "q_heads": ("model",),
    "kv_heads": ("model",),
    "head": (),
    "seq": (),
    # long-context decode: the KV cache's sequence dim takes whatever the
    # batch/head dims left free (model first, then data)
    "cache_seq": ("model", "data"),
}

RULE_SETS: dict[str, dict[str, tuple[str, ...]]] = {
    "train": TRAIN_RULES,
    "serve": SERVE_RULES,
}

# Names resolved after all others (they scavenge leftover mesh axes).
_FALLBACK_NAMES = frozenset({"cache_seq"})


def _take_axes(name: str | None, dim: int, mesh_shape: Mapping[str, int],
               rules: Mapping[str, Sequence[str]], used: set[str]):
    """Greedy prefix of the rule's mesh axes that divides ``dim`` evenly."""
    taken: list[str] = []
    prod = 1
    for ax in rules.get(name, ()) if name is not None else ():
        size = mesh_shape.get(ax, 1)
        if size <= 1 or ax in used:
            continue
        if dim % (prod * size) != 0:
            continue
        taken.append(ax)
        used.add(ax)
        prod *= size
    return taken


def pspec_for(names: Sequence[str | None], shape: Sequence[int],
              mesh, rules: Mapping[str, Sequence[str]]) -> tuple:
    """Partition spec for a tensor with logical axis ``names`` and
    ``shape``: one entry a dim (a mesh-axis name, a tuple of names, or
    ``None``).  Only the mesh's axis sizes are read (a mesh record, a
    DeviceMesh or the reference's meshes)."""
    sizes = mesh_shape(mesh)
    used: set[str] = set()
    parts: list[Any] = [None] * len(names)

    def resolve(i: int):
        taken = _take_axes(names[i], int(shape[i]), sizes, rules, used)
        if len(taken) == 1:
            parts[i] = taken[0]
        elif taken:
            parts[i] = tuple(taken)

    primary = [i for i, n in enumerate(names) if n not in _FALLBACK_NAMES]
    fallback = [i for i, n in enumerate(names) if n in _FALLBACK_NAMES]
    for i in primary:
        resolve(i)
    for i in fallback:
        resolve(i)
    return tuple(parts)


def _is_axes_leaf(x) -> bool:
    return x is None or (isinstance(x, tuple)
                         and all(isinstance(e, str) or e is None for e in x))


def tree_pspecs(axes_tree, abstract_tree, mesh,
                rules: Mapping[str, Sequence[str]]):
    """Map a tree of logical-axes tuples and the matching tree of tensors
    (``meta`` or real; a host number is 0-d) to partition specs, in the
    axes tree's nesting: the reference's ``tree_shardings`` without the
    ``NamedSharding``."""
    def walk(axes, leaf):
        if _is_axes_leaf(axes):
            shape = tuple(getattr(leaf, "shape", ()))
            names = axes if axes is not None else (None,) * len(shape)
            return pspec_for(names, shape, mesh, rules)
        if isinstance(axes, dict):
            return {k: walk(a, leaf[k]) for k, a in axes.items()}
        if hasattr(axes, "_fields"):
            return type(axes)(*(walk(a, x) for a, x in zip(axes, leaf)))
        return [walk(a, x) for a, x in zip(axes, leaf)]

    return walk(axes_tree, abstract_tree)


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis: size}`` of a :class:`DeviceMesh` or of a mesh record."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def placements(pspec, device_mesh) -> tuple:
    """DTensor placements of a partition spec on ``device_mesh``: mesh axis
    ``a`` becomes ``Shard(d)`` when spec entry ``d`` names it (alone or in
    a tuple), else ``Replicate()``."""
    dim_of = {}
    for d, entry in enumerate(pspec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                dim_of[ax] = d
    return tuple(Shard(dim_of[ax]) if ax in dim_of else Replicate()
                 for ax in device_mesh.mesh_dim_names)


def tree_shardings(axes_tree, abstract_tree, mesh,
                   rules: Mapping[str, Sequence[str]]):
    """The reference's ``tree_shardings``: each leaf's ``(DeviceMesh,
    placements)`` on the :class:`DeviceMesh` ``mesh``, in the axes tree's
    nesting (:func:`tree_pspecs` resolved to placements)."""
    specs = tree_pspecs(axes_tree, abstract_tree, mesh, rules)
    return cm.tree_map(lambda _, ps: (mesh, placements(ps, mesh)), specs,
                       is_leaf=is_spec)


def is_spec(x) -> bool:
    """A leaf of a spec or sharding tree (what :func:`tree_pspecs` and
    :func:`tree_shardings` return): a plain tuple."""
    return type(x) is tuple


def flat_specs(tree) -> dict:
    """``{path: leaf}`` of a spec or sharding tree, with
    :func:`repro_torch.models.common.tree_map`'s paths."""
    return dict(cm.leaves(tree, is_leaf=is_spec))


def local_index(shape, device_mesh, places) -> tuple[slice, ...]:
    """The slices of a tensor of ``shape`` that this rank holds on
    ``places`` (even shards; several mesh axes on one dim split it in
    mesh-axis order, as DTensor does)."""
    idx = [slice(0, n) for n in shape]
    coord = device_mesh.get_coordinate()
    for ax, pl in enumerate(places):
        if pl.is_shard():
            s = idx[pl.dim]
            step = (s.stop - s.start) // device_mesh.shape[ax]
            start = s.start + coord[ax] * step
            idx[pl.dim] = slice(start, start + step)
    return tuple(idx)


def distribute(tree, shardings):
    """``tree`` with every tensor placed on its ``(DeviceMesh, placements)``
    of ``shardings`` (same nesting): a real tensor is sliced to this rank's
    shard (every rank holds the same whole tensor, so nothing is sent); a
    ``meta`` tensor becomes a DTensor of ``meta`` local shards."""
    flat = flat_specs(shardings)

    def place(path, t):
        if not isinstance(t, torch.Tensor):
            return t                    # a host number (a cache index)
        dm, places = flat[path]
        if t.is_meta:
            local = torch.empty([s.stop - s.start for s in local_index(
                t.shape, dm, places)], dtype=t.dtype, device="meta")
            return DTensor.from_local(local, dm, places, run_check=False,
                                      shape=t.shape, stride=t.stride())
        return distribute_tensor(t, dm, places, src_data_rank=None)

    return cm.tree_map(place, tree)


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def is_dtensor_type(t) -> bool:
    return issubclass(t, DTensor)


def batch_axes(batch_tree):
    """Logical axes for a data batch: leading ``batch`` dim, rest unsharded."""
    return cm.tree_map(
        lambda _, leaf: ("batch",) + (None,) * (leaf.ndim - 1), batch_tree)


def replicated(mesh) -> tuple:
    """The spec of a value every device holds whole."""
    return ()


# --- activation constraints ------------------------------------------------

_ctx = threading.local()


# the aten ops that ran replicated for want of a DTensor sharding strategy
# at their placements (see _MeshDispatch), by name
FALLBACKS: collections.Counter = collections.Counter()

# the only ops allowed to: the MoE dispatch's writes and the combine's
# gather, the embedding gradient's accumulation, views that would split a
# shard unevenly, a pad of sharded dims, and DTensor values written into a
# plain buffer the model made (a cache's conv or SSM state); ROADMAP
# queue 3 names each.  Any other op without a strategy raises
FALLBACK_OPS = frozenset({"index_put_", "index_put", "index", "view",
                          "_unsafe_view", "constant_pad_nd", "copy_"})

_NO_STRATEGY = ("Sharding propagation failed", "sharding strategy",
                "not supported yet")


def replicate(x):
    """A DTensor gathered whole onto every rank (``Replicate()`` on every
    mesh axis); anything else as it is."""
    if isinstance(x, DTensor) and any(not p.is_replicate()
                                      for p in x.placements):
        return x.redistribute(x.device_mesh,
                              (Replicate(),) * x.device_mesh.ndim)
    return x


def _fall_back(func, args):
    """Count ``func`` in :data:`FALLBACKS`, or raise if it is not one of
    :data:`FALLBACK_OPS`."""
    name = func.overloadpacket.__name__
    if name not in FALLBACK_OPS:
        raise RuntimeError(
            f"{func}: no DTensor sharding strategy at placements "
            f"{[a.placements for a in tree_leaves(args) if is_dtensor(a)]}, "
            f"and it is not among the ops that may run replicated "
            f"(dist.sharding.FALLBACK_OPS)")
    FALLBACKS[name] += 1


def _whole(x):
    return replicate(x).to_local() if is_dtensor(x) else x


def _pad_local(func, x, pad, *rest):
    """``constant_pad_nd`` of a DTensor on its local shard, its placements
    kept (the padded dims gathered first if the mesh shards them):
    PyTorch 2.11's strategy for it returns one placement whatever the
    mesh's rank."""
    widths = {x.ndim - 1 - i: pad[2 * i] + pad[2 * i + 1]
              for i in range(len(pad) // 2)}
    if any(p.is_shard() and widths.get(p.dim % x.ndim)
           for p in x.placements):
        _fall_back(func, (x,))
        x = replicate(x)
    out = func(x.to_local(), pad, *rest)
    shape = list(x.shape)
    for d, w in widths.items():
        shape[d] += w
    _, stride = compute_global_tensor_info(out, x.device_mesh, x.placements)
    return DTensor.from_local(out, x.device_mesh, x.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


_LOCAL_OPS = {torch.ops.aten.constant_pad_nd.default: _pad_local}


def _check_placements(func, out, args):
    """An output DTensor with fewer placements than its mesh has axes (a
    strategy bug of some PyTorch versions) is made whole-replicated when
    every DTensor input was; else it raises, naming the op."""
    def fix(t):
        if not isinstance(t, DTensor) or (
                len(t.placements) == t.device_mesh.ndim):
            return t
        ins = [a for a in tree_leaves(args) if isinstance(a, DTensor)]
        if all(p.is_replicate() for p in t.placements) and all(
                p.is_replicate() for a in ins for p in a.placements):
            return DTensor.from_local(
                t.to_local(), t.device_mesh,
                (Replicate(),) * t.device_mesh.ndim, run_check=False)
        raise RuntimeError(f"{func}: DTensor gave placements {t.placements} "
                           f"on a mesh of {t.device_mesh.ndim} axes")
    return tree_map(fix, out)


def _on_locals(func, mesh, rargs, rkwargs):
    """``func`` on the whole local tensors of replicated DTensor arguments
    (an op with no DTensor strategy at any placements: ``index_put_`` on
    some PyTorch versions); a tensor result is replicated on ``mesh``, an
    argument it returns is returned as the DTensor it was."""
    largs, lkwargs = tree_map(local, (rargs, rkwargs))
    lout = func(*largs, **lkwargs)
    back = {id(loc): arg for loc, arg in zip(largs, rargs)
            if isinstance(arg, DTensor)}
    wrap = _replicated_on(mesh)
    return tree_map(lambda t: back[id(t)] if id(t) in back else wrap(t),
                    lout)


def _replicated_on(mesh):
    def wrap(x):
        if type(x) is torch.Tensor:
            return DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                                      run_check=False)
        return x
    return wrap


def _writes_self(func) -> bool:
    a = func._schema.arguments
    return bool(a) and a[0].alias_info is not None and a[0].alias_info.is_write


class _MeshDispatch(TorchDispatchMode):
    """The mesh's dispatch rules for an aten op with DTensor arguments.

    A plain tensor beside a DTensor (a constant the model made, an input
    batch) is the same tensor on every rank, so it is wrapped as a DTensor
    replicated on every mesh axis (PyTorch's own ``implicit_replication``
    gives such a tensor one placement whatever the mesh's rank on some
    versions).  An op whose DTensor sharding propagation then fails (no
    strategy for the op at its inputs' placements, or a view that would
    split a shard unevenly) runs again on replicated inputs: every sharded
    DTensor argument is gathered first, and the op runs whole on every
    rank.  An op that writes an input writes its replicated result back
    into it; one that writes DTensor values into a plain tensor (a buffer
    the model made) gets them whole.  It works below autograd, so the
    backward and the recomputation of a checkpointed region fall back as
    the forward does.  Each such op is counted in :data:`FALLBACKS`, and
    must be one of :data:`FALLBACK_OPS`: any other raises."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(is_dtensor_type(t) for t in types):
            return func(*args, **kwargs)
        if args and type(args[0]) is torch.Tensor and _writes_self(func):
            # DTensor values written into a plain tensor: gathered whole
            _fall_back(func, args)
            return func(*tree_map(_whole, args), **tree_map(_whole, kwargs))
        mesh = next(x.device_mesh for x in tree_leaves((args, kwargs))
                    if isinstance(x, DTensor))
        args, kwargs = tree_map(_replicated_on(mesh), (args, kwargs))
        if func in _LOCAL_OPS and isinstance(args[0], DTensor):
            return _LOCAL_OPS[func](func, *args, **kwargs)
        try:
            out = func(*args, **kwargs)
            return out if _writes_self(func) else _check_placements(
                func, out, args)
        except (RuntimeError, NotImplementedError) as e:
            if not any(m in str(e) for m in _NO_STRATEGY):
                raise
        _fall_back(func, (args, kwargs))
        rargs, rkwargs = tree_map(replicate, (args, kwargs))
        try:
            out = _check_placements(func, func(*rargs, **rkwargs), rargs)
        except (RuntimeError, NotImplementedError) as e:
            if not any(m in str(e) for m in _NO_STRATEGY):
                raise
            out = _on_locals(func, mesh, rargs, rkwargs)
        for i, a in enumerate(func._schema.arguments):
            if (a.alias_info is not None and a.alias_info.is_write
                    and i < len(args) and rargs[i] is not args[i]):
                args[i].copy_(rargs[i])
                if out is rargs[i]:
                    out = args[i]
        return out


@contextlib.contextmanager
def act_ctx(mesh, rules: Mapping[str, Sequence[str]]):
    """Install the ambient (DeviceMesh, rules) used by :func:`constrain`.
    Inside it a plain tensor met beside a DTensor (a constant the model
    makes, an input batch) counts as replicated on the mesh, and an op
    DTensor cannot run at its inputs' placements runs replicated
    (:class:`_MeshDispatch`)."""
    prev = getattr(_ctx, "current", None)
    _ctx.current = (mesh, rules)
    try:
        with _MeshDispatch():
            yield
    finally:
        _ctx.current = prev


def current():
    """The ambient (DeviceMesh, rules), or ``None`` outside
    :func:`act_ctx`."""
    return getattr(_ctx, "current", None)


class _Constrain(torch.autograd.Function):
    """A redistribution to fixed placements whose cotangent is pinned to the
    same placements, as the reference's sharding constraint transposes, and
    then sent back to the input's placements (a partial sum there taken as
    replicated), as DTensor's ``redistribute`` does.  DTensor's own
    ``redistribute`` skips the first step, and is not there at all when the
    input is at its placements already: a partial-sum cotangent would then
    pass the constraint unreduced and run the next product of the backward
    whole on every rank of the axis."""

    @staticmethod
    def forward(ctx, x, mesh, want):
        ctx.mesh, ctx.want = mesh, want
        ctx.back = tuple(Replicate() if p.is_partial() else p
                         for p in x.placements)
        if tuple(x.placements) == want:
            return x.view_as(x)
        return x.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, g):
        for places in (ctx.want, ctx.back):
            if tuple(g.placements) != places:
                g = g.redistribute(ctx.mesh, places)
        return g, None, None


def constrain(x, names: Sequence[str | None]):
    """Pin an activation, and its gradient, to the placements of its
    logical axis ``names``.

    Inside an :func:`act_ctx` a DTensor is redistributed to the spec's
    placements (a gather, a reduce-scatter of a partial sum, or a local
    slice, whatever it takes; nothing when it is there already), and so is
    its cotangent in the backward, as the reference's
    ``with_sharding_constraint`` transposes.  Outside the context, and on
    a plain tensor, the identity."""
    cur = current()
    if cur is None or not isinstance(x, DTensor):
        return x
    mesh, rules = cur
    want = placements(pspec_for(names, x.shape, mesh, rules), mesh)
    if not x.requires_grad:
        return x if tuple(x.placements) == want else x.redistribute(mesh,
                                                                    want)
    return _Constrain.apply(x, mesh, want)


def heads_local(fn, q, k, v):
    """``fn(q, k, v)`` (an attention: [B, T, H, D] in and out) run on each
    rank's batch rows and heads, the output placed as ``q`` is.

    Attention is independent across batch rows and heads, so it needs no
    collective once every rank holds its queries' keys and values whole
    along the sequence: ``q`` keeps its batch and head shards (any other
    is gathered); the keys and values take ``q``'s batch shards, and its
    head shards where both head counts divide the axis (the blocks then
    match), else are gathered along the heads and sliced here to the
    groups of this rank's query heads.  Flattening a batch and a head
    shard together, as an ``einsum`` over them does, is a reshape that
    some PyTorch versions' DTensor cannot do without gathering both."""
    mesh = q.device_mesh
    Hq, Hkv = q.shape[2], k.shape[2]
    g = Hq // Hkv
    q_pl = [p if p.is_shard() and p.dim in (0, 2) else Replicate()
            for p in q.placements]
    heads = [p.is_shard() and p.dim == 2 for p in q_pl]
    if any(heads) and not all(Hkv % n == 0 for n, h in zip(mesh.shape, heads)
                              if h):
        # kv heads gathered; this rank's query heads must then cover whole
        # groups, or sit inside one
        n_q = Hq // math.prod(n for n, h in zip(mesh.shape, heads) if h)
        if n_q % g and g % n_q:
            q_pl = [Replicate() if h else p for p, h in zip(q_pl, heads)]
        kv_pl = [p if p.is_shard() and p.dim == 0 else Replicate()
                 for p in q_pl]
    else:
        kv_pl = list(q_pl)
    q, k, v = (x if list(x.placements) == pl else x.redistribute(mesh, pl)
               for x, pl in ((q, q_pl), (k, kv_pl), (v, kv_pl)))
    # where the queries' heads are split and the keys' are not, each rank
    # uses its own groups of them: their gradients are partial sums there
    kv_grad = [Partial() if qp.is_shard() and qp.dim == 2 and kp.is_replicate()
               else kp for qp, kp in zip(q_pl, kv_pl)]
    ql = q.to_local()
    kl, vl = (x.to_local(grad_placements=kv_grad) for x in (k, v))
    if kl.shape[2] == Hkv and ql.shape[2] < Hq:
        first = local_index(q.shape, mesh, q_pl)[2].start
        lo, hi = first // g, (first + ql.shape[2] - 1) // g + 1
        kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
    return DTensor.from_local(fn(ql, kl, vl), mesh, q_pl, run_check=False,
                              shape=q.shape, stride=q.stride())


def local(x):
    """This rank's shard of a DTensor (sharing its storage), or ``x``."""
    return x.to_local() if is_dtensor(x) else x


def like(x, ref):
    """``x`` placed as the DTensor ``ref`` is (a reduce-scatter of a partial
    gradient, a slice of a replicated one); ``x`` when either is plain."""
    if is_dtensor(x) and is_dtensor(ref) and (
            tuple(x.placements) != tuple(ref.placements)):
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


def full(x):
    """The whole tensor of a DTensor (gathered on every rank), or ``x``."""
    return x.full_tensor() if is_dtensor(x) else x
