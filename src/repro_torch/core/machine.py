"""Physical/virtual machine state codes (paper §3.4.2-3.4.3, Fig. 5-6).

Port of ``repro.core.machine``: the same codes, the same flat spreader
layout, and the same masked helpers over int8 state tensors.
"""
from __future__ import annotations

import torch

# --- VM states (paper Fig. 6) ------------------------------------------------
VM_FREE = 0
VM_INITIAL_TRANSFER = 1
VM_STARTUP = 2
VM_RUNNING = 3
VM_SHUTDOWN = 4
VM_SUSPEND_TRANSFER = 5
VM_MIGRATING = 6
VM_SUSPENDED = 7
VM_RESUME_TRANSFER = 8
VM_ALLOCATED = 9
N_VM_STATES = 10

# VM states whose own CPU spreader must be performing.
VM_CPU_ACTIVE = (VM_STARTUP, VM_RUNNING, VM_SUSPEND_TRANSFER,
                 VM_RESUME_TRANSFER)

from .energy import PM_OFF, PM_RUNNING, PM_SWITCHING_OFF, PM_SWITCHING_ON  # noqa: E402,F401


def vm_cpu_active(vstage: torch.Tensor) -> torch.Tensor:
    m = torch.zeros_like(vstage, dtype=torch.bool)
    for s in VM_CPU_ACTIVE:
        m = m | (vstage == s)
    return m


def pm_accepting(pstate: torch.Tensor) -> torch.Tensor:
    """PMs that can receive new VM allocations right now."""
    return pstate == PM_RUNNING


def pm_future_capacity(pstate: torch.Tensor) -> torch.Tensor:
    """PMs that are running or booting (on-demand's wake arithmetic)."""
    return (pstate == PM_RUNNING) | (pstate == PM_SWITCHING_ON)


class SpreaderLayout:
    """Index arithmetic for the flat spreader space.

    Layout: ``[cpu: P][net_in: P][net_out: P][repo_out: 1][repo_disk: 1]
    [vm_cpu: V][hidden: P]``.
    """

    def __init__(self, n_pm: int, n_vm: int):
        self.P = n_pm
        self.V = n_vm
        self.cpu0 = 0
        self.netin0 = n_pm
        self.netout0 = 2 * n_pm
        self.repo_out = 3 * n_pm
        self.repo_disk = 3 * n_pm + 1
        self.vm0 = 3 * n_pm + 2
        self.hidden0 = self.vm0 + n_vm
        self.S = self.hidden0 + n_pm
