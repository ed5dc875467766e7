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
serve.  The dry run records the specs of every leaf
(:mod:`repro_torch.launch.dryrun`); the port runs on one device, so
nothing is placed by them, and the reference's activation constraints
(``act_ctx`` / ``constrain``) wait for ROADMAP queue 1, item 16.

Two rule sets ship: :data:`TRAIN_RULES` (FSDP over ``data`` + TP over
``model``) and :data:`SERVE_RULES` (weights replicated over ``data``, TP
over ``model``, long-context KV-cache sequence sharding).
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

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
    ``None``).  Only ``mesh.shape`` is consulted."""
    mesh_shape = dict(mesh.shape)
    used: set[str] = set()
    parts: list[Any] = [None] * len(names)

    def resolve(i: int):
        taken = _take_axes(names[i], int(shape[i]), mesh_shape, rules, used)
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


def batch_axes(batch_tree):
    """Logical axes for a data batch: leading ``batch`` dim, rest unsharded."""
    return cm.tree_map(
        lambda _, leaf: ("batch",) + (None,) * (leaf.ndim - 1), batch_tree)


def replicated(mesh) -> tuple:
    """The spec of a value every device holds whole."""
    return ()
