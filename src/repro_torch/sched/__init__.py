"""Scheduling on top of the core engine (mirrors ``repro.sched``):
:mod:`~repro_torch.sched.registry` and the builtin
:mod:`~repro_torch.sched.policies`."""
from . import registry  # noqa: F401
