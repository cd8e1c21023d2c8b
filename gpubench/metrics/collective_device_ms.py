"""Device milliseconds a step of the NCCL kernels on rank 0."""

from gpubench import trace


def read(ctx):
    t = ctx.run.trace
    seconds, n = trace.device_s(t, ("nccl",))
    if not n:
        return None
    return seconds * 1e3 / t.steps
