"""``masked_min``'s share of its roofline over the traced slice: the least
time of the bytes its launches needed (each launch's lanes and candidate
count, recorded in a rerun of the slice) at the chip's peak bandwidth,
over the kernel's device time in the trace."""
from portbench import roofline


def read(ctx):
    peak = roofline.peaks(ctx.device_name)
    launches, seconds = ctx.slice.kernel("masked_min_kernel")
    calls = ctx.counters.get("masked_min")
    if not peak or not launches or seconds <= 0 or not calls:
        return None
    if len(calls) != launches:
        return None
    need = sum(roofline.masked_min_bytes(c["n_lanes"], c["n"]) for c in calls)
    return 100.0 * (need / peak["bytes_per_s"]) / seconds
