"""K6's share of its roofline on rank 0: the sum of each profiled
launch's bound (`kernels/plane_sweep_occ.py`, fp32 peak: the kernel
computes in fp32) over K6's device time in the profile. Each launch's
geometry comes from the forwards the harness kept during the profiled
steps of the device alone."""

from gpubench import trace
from gpubench.kernels import plane_sweep_occ
from gpubench.peaks import PEAK_FLOPS, bound_s


def read(ctx):
    seconds, n = trace.device_s(ctx.run.trace, plane_sweep_occ.KERNEL_NAMES)
    kept = ctx.run.captured.get("plane_sweep_occ", [])
    if not n or n != len(kept):
        return None
    bound = 0.0
    for k in kept:
        g = plane_sweep_occ.launch_inputs(k)
        found = plane_sweep_occ.samples(g["poses"], g["K"], g["inv_K"],
                                        g["bins"], g["occ"], g["apply"],
                                        g["pool_th"], g["h"], g["w"])
        frames = g["poses"].shape[0] * g["poses"].shape[1]
        bound += bound_s(*plane_sweep_occ.counts(
            frames, g["h"], g["w"], g["bins"].shape[0], found,
            int(g["apply"].sum())), PEAK_FLOPS["float32"])
    return 100.0 * bound / seconds
