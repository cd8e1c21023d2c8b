"""Device milliseconds a step of the kernels launched inside DualRefine's
span around its gradient-free fixed-point solve (`mal.dualref.solve`,
`mal_tpu_torch/dualref/model.py`; the Gauss-Newton steps inside it
included), rank 0's, from the profiled steps that record the host's spans.
Nothing where the program opens no such span."""

from gpubench import trace

SPAN = "mal.dualref.solve"


def read(ctx):
    t = ctx.run.host_trace
    if t is None:
        return None
    seconds = trace.device_s_in_span(t, SPAN)
    if seconds <= 0:
        return None
    return seconds * 1e3 / t.steps
