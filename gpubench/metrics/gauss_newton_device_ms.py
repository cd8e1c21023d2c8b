"""Device milliseconds a step of the kernels launched inside DualRefine's
spans around its Gauss-Newton pose steps (`mal.dualref.gauss_newton`,
each `direct_align`, `mal_tpu_torch/dualref/model.py`), rank 0's, from the
profiled steps that record the host's spans: forward launches only, the
8 Gauss-Newton steps of a step at the defaults (the solve's 6 and the
phantom unroll's on the step's thread, the unroll's recompute on
autograd's thread, whose span holds its own launches). The backward's
kernels are launched by autograd outside any such span. Nothing where the
program opens no such span."""

from gpubench import trace

SPAN = "mal.dualref.gauss_newton"


def read(ctx):
    t = ctx.run.host_trace
    if t is None:
        return None
    seconds = trace.device_s_in_span(t, SPAN)
    if seconds <= 0:
        return None
    return seconds * 1e3 / t.steps
