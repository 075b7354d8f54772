"""Device kernels a call launches: the profiler's count of device kernel
activities (copies and fills left out) over the traced slice, per call."""


def read(ctx):
    s = ctx.slice
    return None if s is None or not s.calls else s.kernels / s.calls
