"""The traced sub-windows: `torch.profiler` over a few steps of the
device alone, then over a few with the host's operations and spans; each
Chrome trace read back into device operations, launches and host spans,
and the arithmetic every reader shares (the union of the device's busy intervals,
copied from the port's `utils/profiling.py:busy_us`; the idle gaps by what
the host was doing; device time by kernel and by span)."""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
EXCLUDED = ("Buffer Flush",)   # the profiler's own activity


@dataclasses.dataclass
class Trace:
    """Events of one process's profiled sub-window, times in microseconds.
    `device`: (name, start, duration, correlation); `launches`: correlation
    -> (start, thread); `host`: (name, start, duration, thread)."""
    device: list
    launches: dict
    host: list
    window_s: float          # host clock over the profiled steps
    steps: int               # steps profiled


def read_chrome_trace(path: str, window_s: float, steps: int) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, launches, host = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args", {})
        if cat in DEVICE_CATS and e["name"] not in EXCLUDED:
            device.append((e["name"], float(e["ts"]), float(e["dur"]),
                           args.get("correlation")))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (float(e["ts"]), e.get("tid"))
        elif cat in HOST_CATS:
            host.append((e["name"], float(e["ts"]), float(e["dur"]),
                         e.get("tid")))
    device.sort(key=lambda d: d[1])
    return Trace(device, launches, host, window_s, steps)


def profile_steps(run_steps, steps: int, synchronize, clock,
                  host: bool) -> Trace:
    """Run `run_steps(steps)` under `torch.profiler`, ending in
    `synchronize()`, and read its trace. With `host` the profiler records
    the host's operations and spans too, which slows the host several
    times over: the device's busy and idle time come from a run without
    them. The trace file lives in the run's temporary directory only
    while it is read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    if host or not activities:   # the tests' runs on the CPU
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = clock()
        run_steps(steps)
        synchronize()
        window_s = clock() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return read_chrome_trace(path, window_s, steps)
    finally:
        os.unlink(path)


def merged_intervals(trace: Trace) -> list[tuple[float, float]]:
    """The device's busy intervals: the union of its operations."""
    merged: list[list[float]] = []
    for _, start, dur, _ in trace.device:
        end = start + dur
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def busy_s(trace: Trace) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(b - a for a, b in merged_intervals(trace)) * 1e-6


def device_s(trace: Trace, fragments: tuple[str, ...]) -> tuple[float, int]:
    """(seconds, operations) of the device operations whose name holds one
    of `fragments`."""
    hits = [d for d in trace.device if any(f in d[0] for f in fragments)]
    return sum(d[2] for d in hits) * 1e-6, len(hits)


def device_s_in_span(trace: Trace, span: str) -> float:
    """Seconds of the device operations launched inside a host span named
    `span` (on the launching thread)."""
    spans = [(s, s + d, tid) for name, s, d, tid in trace.host if name == span]
    total = 0.0
    for _, _, dur, corr in trace.device:
        launch = trace.launches.get(corr)
        if launch is None:
            continue
        ts, tid = launch
        if any(a <= ts <= b and t == tid for a, b, t in spans):
            total += dur
    return total * 1e-6


def _host_label(trace: Trace, ts: float, tid) -> str:
    """The innermost host span and operation around `ts` on thread `tid`."""
    around = [(d, n) for n, s, d, t in trace.host
              if t == tid and s <= ts <= s + d]
    if not around:
        return "host idle"
    return sorted(around)[0][1]


def breakdown(trace: Trace, host_trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time (`trace`, the device
    alone), and the longest idle gaps on the device (`host_trace`, with
    the host recorded) labelled by what the host was doing when the next
    operation was launched, each in seconds as measured."""
    by_name: dict[str, float] = {}
    for name, _, dur, _ in trace.device:
        by_name[name[:160]] = by_name.get(name[:160], 0.0) + dur * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    intervals = merged_intervals(host_trace)
    starts = {}
    for _, start, _, corr in host_trace.device:
        starts.setdefault(start, corr)
    gaps = sorted(((nxt - end, nxt) for (_, end), (nxt, _)
                   in zip(intervals, intervals[1:])), reverse=True)[:top]
    idle = []
    for length, nxt in gaps:
        launch = host_trace.launches.get(starts.get(nxt))
        label = (_host_label(host_trace, launch[0], launch[1]) if launch
                 else "unattributed")
        idle.append([label[:160], length * 1e-6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": idle}
