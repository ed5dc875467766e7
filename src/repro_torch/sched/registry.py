"""The scheduler-policy registry (port of ``repro.sched.registry``).

A policy is a stage function ``policy(spec, params, ctx, state) -> state``
registered under a stable integer code per management layer (``"pm"``
physical-machine state scheduling, ``"vm"`` request dispatching).  Codes
are contiguous and append-only and keep the reference's numbering.

A single scenario knows its policy codes on the host, so the loop stages
call the selected policy directly (the reference ``lax.switch``es over
:func:`stage_branches`).  A policy's ``trigger`` is kept as metadata: it is
a necessary condition for the policy to act, and the port runs the body
unconditionally, which the trigger contract makes exact.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

LAYERS = ("pm", "vm")


@dataclasses.dataclass(frozen=True)
class Policy:
    """One registered scheduler policy and its metadata."""

    code: int
    name: str
    layer: str
    fn: Callable
    requires: tuple[str, ...] = ()
    starts_running: bool = False
    doc: str = ""
    trigger: Callable | None = None


_registry: dict[str, dict[int, Policy]] = {layer: {} for layer in LAYERS}
_loading_builtins = False
_builtins_done = False


def _ensure_builtins() -> None:
    """Load the builtin policy package once (it registers on import)."""
    global _loading_builtins, _builtins_done
    if _builtins_done or _loading_builtins:
        return
    _loading_builtins = True
    try:
        from . import policies  # noqa: F401  (side effect: register())
        _builtins_done = True
    finally:
        _loading_builtins = False


def _check_layer(layer: str) -> None:
    if layer not in LAYERS:
        raise ValueError(f"unknown scheduler layer {layer!r}; one of {LAYERS}")


def register(layer: str, name: str, fn: Callable, *, code: int | None = None,
             requires: tuple[str, ...] = (), starts_running: bool = False,
             doc: str = "", trigger: Callable | None = None) -> Policy:
    """Register ``fn`` under the next free code of ``layer``."""
    _check_layer(layer)
    _ensure_builtins()
    table = _registry[layer]
    next_code = len(table)
    if code is None:
        code = next_code
    if code != next_code:
        raise ValueError(f"{layer} policy codes are contiguous and "
                         f"append-only: next free code is {next_code}, got "
                         f"{code}")
    if any(p.name == name for p in table.values()):
        raise ValueError(f"duplicate {layer} policy name {name!r}")
    from ..core.loop.state import CloudState
    unknown = set(requires) - set(CloudState._fields)
    if unknown:
        raise ValueError(f"policy {name!r} requires unknown CloudState "
                         f"field(s) {sorted(unknown)}")
    policy = Policy(code=code, name=name, layer=layer, fn=fn,
                    requires=tuple(requires), starts_running=starts_running,
                    doc=doc, trigger=trigger)
    table[code] = policy
    return policy


def get(layer: str, code_or_name: int | str) -> Policy:
    """Look a policy up by stable code or by name."""
    _check_layer(layer)
    _ensure_builtins()
    table = _registry[layer]
    if isinstance(code_or_name, str):
        for p in table.values():
            if p.name == code_or_name:
                return p
        raise KeyError(f"unknown {layer} policy {code_or_name!r}; "
                       f"registered: {names(layer)}")
    code = int(code_or_name)
    if code not in table:
        raise KeyError(f"unknown {layer} policy code {code}; registered: "
                       f"0..{len(table) - 1}")
    return table[code]


def policies(layer: str) -> tuple[Policy, ...]:
    _check_layer(layer)
    _ensure_builtins()
    table = _registry[layer]
    return tuple(table[c] for c in range(len(table)))


def names(layer: str) -> tuple[str, ...]:
    """Registered policy names ordered by code (index == code)."""
    return tuple(p.name for p in policies(layer))


def code_of(layer: str, name: str) -> int:
    return get(layer, name).code


def stage_branches(layer: str, ctx) -> tuple[Callable, ...]:
    """One ``(st) -> st`` callable per code, in code order, closed over the
    pass's :class:`~repro_torch.core.loop.state.StageCtx`."""

    def bind(fn):
        return lambda st: fn(ctx.spec, ctx.params, ctx, st)

    return tuple(bind(p.fn) for p in policies(layer))


def trigger_branches(layer: str, ctx) -> tuple[Callable, ...]:
    """The event-gate callables matching :func:`stage_branches`; a policy
    without a trigger may always act."""
    import torch

    def bind(p):
        if p.trigger is None:
            return lambda st: torch.ones((), dtype=torch.bool)
        return lambda st: p.trigger(ctx.spec, ctx.params, ctx, st)

    return tuple(bind(p) for p in policies(layer))


def start_running_codes() -> tuple[int, ...]:
    """PM policy codes whose fleets begin powered on."""
    return tuple(p.code for p in policies("pm") if p.starts_running)
