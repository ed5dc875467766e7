"""Device kernels launched in the traced slice per 1,000 simulated lane
events (every kernel the trace shows, the port's own ctypes-loaded ones
included): the host's enqueue work of the stages and the policy
dispatch."""


def read(ctx):
    s = ctx.slice
    if not s.lane_events or not s.n_kernels:
        return None
    return s.n_kernels / (s.lane_events / 1000.0)
