"""Device-to-host reads of the traced slice per 1,000 simulated lane
events: each read stalls the host's enqueue until the device has caught
up (the event loop's per-pass condition, the influence fixpoint's and the
dispatch loop's rounds, the answers brought back)."""


def read(ctx):
    s = ctx.slice
    if not s.lane_events or not s.dtoh_reads:
        return None
    return s.dtoh_reads / (s.lane_events / 1000.0)
