"""``maxmin_solve``'s share of its roofline over the traced slice: the
least time of the bytes its launches needed (from each launch's lane
count, flow count, live flows and touched spreaders, counted in a rerun
of the slice) at the chip's peak bandwidth, over the kernel's device time
in the trace."""
from portbench import roofline


def read(ctx):
    peak = roofline.peaks(ctx.device_name)
    launches, seconds = ctx.slice.kernel("maxmin_solve_kernel")
    calls = ctx.counters.get("maxmin_solve")
    if not peak or not launches or seconds <= 0 or not calls:
        return None
    if len(calls) != launches:
        return None
    need = sum(roofline.solve_bytes(c["n_flows"], c["n_live"], c["n_touched"])
               for c in calls)
    return 100.0 * (need / peak["bytes_per_s"]) / seconds
