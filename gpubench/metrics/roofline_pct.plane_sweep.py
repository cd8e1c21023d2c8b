"""K1's share of its roofline on rank 0: the sum of each profiled
launch's bound (`kernels/plane_sweep.py`, fp32 peak: the kernel computes
in fp32 in every mode) over K1's device time in the profile. The counts
need each launch's geometry, which `kernels/plane_sweep.py:capture` keeps
from the inputs of the port's matching encoder during the profiled steps."""

from gpubench import trace
from gpubench.kernels import plane_sweep
from gpubench.peaks import PEAK_FLOPS, bound_s


def read(ctx):
    t = ctx.run.trace
    seconds, n = trace.device_s(t, plane_sweep.KERNEL_NAMES)
    launches = ctx.run.captured.get("plane_sweep", [])
    if not n or n != len(launches):
        return None
    bound = 0.0
    for k in launches:
        B, _, H, W = k["shape"]
        h, w = H // 4, W // 4
        bins = plane_sweep.depth_bins(k["min"], k["max"], k["planes"])
        active = plane_sweep.active_samples(k["poses"], k["K"], k["inv_K"],
                                            bins, h, w)
        frames = B * k["poses"].shape[1]
        bound += bound_s(*plane_sweep.counts(frames, h, w, k["planes"], active),
                         PEAK_FLOPS["float32"])
    return 100.0 * bound / seconds
