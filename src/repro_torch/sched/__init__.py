"""Scheduling on top of the core engine (mirrors ``repro.sched``):
:mod:`~repro_torch.sched.registry`, the builtin
:mod:`~repro_torch.sched.policies`, and
:mod:`~repro_torch.sched.energy_aware`, which schedules the LM jobs of the
dry run on a fleet of 8-GPU H100 nodes, one node a PM, and scores every
VM x PM policy pair by the meter stack's energy."""
from . import registry  # noqa: F401
