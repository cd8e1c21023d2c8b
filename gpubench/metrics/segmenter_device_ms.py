"""Device milliseconds a step of the kernels launched inside the
harness's span around the segmenter (`train_cell.SEG_SPAN`), rank 0's,
from the profiled steps that record the host's spans."""

from gpubench import trace
from gpubench.train_cell import SEG_SPAN


def read(ctx):
    t = ctx.run.host_trace
    seconds = trace.device_s_in_span(t, SEG_SPAN)
    if seconds <= 0:
        return None
    return seconds * 1e3 / t.steps
