"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  ``launch_counts`` / ``reset_launch_counts`` read and clear the
wrappers' launch counters (a wrapper counts only the launches of its
kernel, never a call that took the plain version).  ``launch_counts`` has
one entry per TPU kernel replaced; ``sub_launch_counts`` splits two of
them: the bf16 launches among ``flash_attention``'s (on the mma.sync
kernel and on the wgmma kernel), and the plan builds that
``fill_stats``'s rounds walk."""
from __future__ import annotations


def _wrappers():
    from . import attention, horizon, maxmin, ssm
    return {"maxmin_solve": maxmin.maxmin_solve,
            "fill_stats": maxmin.fill_stats,
            "masked_min": horizon.masked_min,
            "flash_attention": attention.flash_attention,
            "linear_scan": ssm.linear_scan}


def _sub_counters():
    from . import attention, maxmin
    return {"flash_attention_mma": (attention.flash_attention,
                                    "mma_launches"),
            "flash_attention_wgmma": (attention.flash_attention,
                                      "wgmma_launches"),
            "fill_plan": (maxmin.fill_plan, "launches")}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _wrappers().items()}


def sub_launch_counts() -> dict[str, int]:
    return {name: getattr(fn, attr)
            for name, (fn, attr) in _sub_counters().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
    for fn, attr in _sub_counters().values():
        setattr(fn, attr, 0)
