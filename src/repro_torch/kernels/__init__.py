"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  ``launch_counts`` / ``reset_launch_counts`` read and clear the
wrappers' launch counters (a wrapper counts only the launches of its
kernel, never a call that took the plain version)."""
from __future__ import annotations


def _wrappers():
    from . import horizon, maxmin
    return {"maxmin_solve": maxmin.maxmin_solve,
            "fill_stats": maxmin.fill_stats,
            "masked_min": horizon.masked_min}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
