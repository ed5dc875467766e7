"""Shared model-building blocks and the parameter-spec machinery (port of
``repro/models/common.py``).

Model code builds a tree of :class:`ParamSpec` leaves (shape + logical axes +
initializer); :func:`materialize` turns it into tensors on a device,
:func:`abstract` into ``meta`` tensors (the dry run) and
:func:`logical_axes` into the axes that ``repro_torch.dist.sharding`` maps
onto a mesh.  The tree keeps the reference's nesting, so
:func:`params_from_numpy` can take the JAX package's materialised
parameters as numpy arrays and :func:`to_numpy` gives them back.

Storage dtype.  The reference keeps every parameter in f32 and casts at use.
The port stores in the compute dtype each leaf that the reference only ever
reads through ``.astype(compute dtype)`` (:data:`CAST_AT_USE`), and keeps the
others (norm weights, the MoE router, Mamba's conv/A/D/dt-bias leaves, RWKV's
time and channel mixes, which the reference computes in f32) in f32.
The numbers are the same, since the cast happens once instead of at each
use; at full width it halves the memory of the weights.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# leaves the reference reads only through ``.astype(compute dtype)``
CAST_AT_USE = frozenset({
    "embed", "unembed", "wq", "wk", "wv", "wo", "w_gu", "w_down",
    "in_proj", "x_proj", "dt_w", "out_proj"})


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (or a torch dtype) as a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return DTYPES[str(name)]


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative description of one parameter tensor."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]           # logical axis name per dim
    init: str = "fan_in"                   # fan_in | normal | zeros | ones | const
    scale: float = 1.0                     # stddev multiplier / const value
    fan_in: int | None = None              # override fan-in for "fan_in"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


def spec(shape, axes, init="fan_in", scale=1.0, fan_in=None) -> ParamSpec:
    return ParamSpec(tuple(int(s) for s in shape), tuple(axes), init, scale,
                     fan_in)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn, tree, prefix=(), is_leaf=None):
    """``fn(path, leaf)`` over a tree of dicts, lists and named tuples; keeps
    the nesting.  Dict keys are visited in sorted order, a named tuple's
    fields in their order (each under its name, as in a JAX key path).  A
    node for which ``is_leaf`` is true is a leaf (a partition spec, which
    is a plain tuple)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], prefix + (k,), is_leaf)
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, getattr(tree, k), prefix + (k,),
                                     is_leaf)
                            for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, prefix + (str(i),), is_leaf)
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def leaves(tree, is_leaf=None) -> list:
    """``(path, leaf)`` pairs of a tree, in :func:`tree_map` order."""
    out = []
    tree_map(lambda path, leaf: out.append((path, leaf)), tree,
             is_leaf=is_leaf)
    return out


def count_params(tree) -> int:
    return sum(math.prod(ps.shape) for _, ps in leaves(tree))


def abstract(tree, dtype=torch.float32):
    """The spec tree as ``meta`` tensors of ``dtype`` (shapes and dtypes, no
    storage): the dry run's parameters."""
    dt = torch_dtype(dtype)
    return tree_map(
        lambda _, ps: torch.empty(ps.shape, dtype=dt, device="meta"), tree)


def logical_axes(tree):
    """Same-structure tree of logical-axes tuples."""
    return tree_map(lambda _, ps: ps.axes, tree)


def stack_specs(tree, n: int, axis_name: str = "layers"):
    """Prepend a stacking dim (the per-pattern-position layer stack)."""
    return tree_map(
        lambda _, ps: ParamSpec((n,) + ps.shape, (axis_name,) + ps.axes,
                                ps.init, ps.scale, ps.fan_in), tree)


def storage_dtype(path, compute_dtype) -> torch.dtype:
    """The dtype a parameter at ``path`` is kept in (module docstring)."""
    return (torch_dtype(compute_dtype) if path and path[-1] in CAST_AT_USE
            else torch.float32)


def seeded_generator(seed: int, device) -> torch.Generator | None:
    """A generator on ``device`` seeded with ``seed``; ``None`` on the
    ``meta`` device, whose tensors draw nothing."""
    dev = torch.device(device)
    if dev.type == "meta":
        return None
    return torch.Generator(device=dev).manual_seed(seed)


def _init_leaf(ps: ParamSpec, dtype, device, generator):
    if ps.init == "zeros":
        return torch.zeros(ps.shape, dtype=dtype, device=device)
    if ps.init == "ones":
        return torch.ones(ps.shape, dtype=dtype, device=device)
    if ps.init == "const":
        return torch.full(ps.shape, ps.scale, dtype=dtype, device=device)
    if ps.init == "normal":
        std = ps.scale
    elif ps.init == "fan_in":
        fan = ps.fan_in or max(math.prod(ps.shape[:-1]), 1)
        std = ps.scale * fan ** -0.5
    else:
        raise ValueError(ps.init)
    out = torch.empty(ps.shape, dtype=dtype, device=device)
    return out.normal_(0.0, std, generator=generator)


def materialize(tree, generator: torch.Generator, *, device=None,
                compute_dtype="float32"):
    """Random parameters for a spec tree, each leaf made on ``device`` at its
    storage dtype (:func:`storage_dtype`).  Leaves draw from ``generator``
    (which must live on ``device``) in sorted path order.  The numbers are
    not those of the reference's ``jax.random``: to compare the two
    packages, materialise there and use :func:`params_from_numpy`."""
    dev = resolve_device(device)
    return tree_map(
        lambda path, ps: _init_leaf(ps, storage_dtype(path, compute_dtype),
                                    dev, generator), tree)


def params_from_numpy(tree, *, device=None, compute_dtype="float32"):
    """The port's parameter tree from the reference's, as numpy arrays (same
    nesting), each leaf at its storage dtype on ``device``."""
    dev = resolve_device(device)
    return tree_map(
        lambda path, a: torch.from_numpy(np.array(a, np.float32)).to(
            device=dev, dtype=storage_dtype(path, compute_dtype)), tree)


def to_numpy(tree):
    """Tensors -> f32 numpy arrays (other leaves, such as ints, unchanged)."""
    return tree_map(
        lambda _, t: (t.detach().float().cpu().numpy()
                      if isinstance(t, torch.Tensor) else t), tree)


# ---------------------------------------------------------------------------
# Normalisation / activations / rotary embeddings
# ---------------------------------------------------------------------------


def rms_norm(x, weight, *, eps=1e-6, offset=0.0):
    """RMSNorm.  ``offset=1.0`` gives the gemma convention (weight ~ 0)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (offset + weight.float())).to(dt)


def layer_norm(x, weight, bias, *, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight + bias).to(dt)


def group_norm(x, weight, bias, groups, *, eps=1e-5):
    """Per-head group norm used by RWKV time-mix output ([B,T,H*D])."""
    dt = x.dtype
    B, T, HD = x.shape
    x = x.float().reshape(B, T, groups, HD // groups)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = ((x - mu) * torch.rsqrt(var + eps)).reshape(B, T, HD)
    return (x * weight + bias).to(dt)


def silu(x):
    return x * torch.sigmoid(x)


def gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


ACTIVATIONS = {"silu": silu, "gelu": gelu, "relu": torch.relu}


def softplus(x):
    """``jax.nn.softplus``: ``log(1 + exp(x))`` with no threshold (torch's
    ``softplus`` returns ``x`` above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def rope(x, positions, *, theta: float = 10000.0):
    """Rotary position embedding.  x: [..., T, H, D]; positions: [..., T]."""
    D = x.shape[-1]
    dt = x.dtype
    half = D // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].float() * freq              # [..., T, half]
    ang = ang[..., :, None, :]                                # head axis
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c, s = torch.cos(ang), torch.sin(ang)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


def sinusoidal_positions(n: int, d: int, *, max_scale: float = 1e4,
                         device=None):
    """Classic transformer sinusoidal table [n, d] (seamless encoder), on
    ``device`` (the GPU by default)."""
    dev = resolve_device(device)
    pos = torch.arange(n, dtype=torch.float32, device=dev)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=dev)[None, :]
    ang = pos / (max_scale ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def softcap(x, cap: float):
    """gemma2-style tanh soft-capping (no-op when cap == 0)."""
    if cap and cap > 0:
        return cap * torch.tanh(x / cap)
    return x
