"""Profiling and timing utilities, the port's counterpart of
`mal_tpu.utils.profiling`, and the one definition of the device timings
`chip_smoke.py` prints.

The reference has only wall-clock prints (`manydepth/evaluate_depth.py:
175-176`, `trainer.py:1521-1531`). Here: a `torch.profiler` trace exported
for Chrome's trace viewer, steady-state timing (CUDA events on a CUDA
device, the host clock on the CPU), a throughput meter, and a step's device
idle share.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with `torch.profiler` (the CPU, and CUDA when a
    card is present) and write `log_dir/trace.json` for Chrome's trace
    viewer (chrome://tracing, Perfetto). Yields the profile, whose
    `key_averages()` gives the table."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 1,
            **kwargs) -> dict:
    """Steady-state time of `fn(*args, **kwargs)`: the mean over `iters`
    calls after `warmup`. Where the first warm-up result holds a CUDA
    tensor the calls are timed by CUDA events on the current stream, else
    by the host clock (CPU work is done when the call returns)."""
    result = None
    for _ in range(max(warmup, 1)):
        result = fn(*args, **kwargs)
    on_card = any(isinstance(t, torch.Tensor) and t.is_cuda
                  for t in tree_leaves(result))
    if on_card:
        return {"mean_ms": cuda_time_ms(lambda: fn(*args, **kwargs), iters,
                                        warmup=0), "iters": iters}
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    dt = (time.perf_counter() - t0) / iters
    return {"mean_ms": dt * 1000.0, "iters": iters}


def cuda_time_ms(fn: Callable, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def busy_us(spans) -> float:
    """The length of the union of (start, end) intervals: the device's busy
    time when kernels overlap (cuDNN may run on streams of its own)."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(spans):
        total += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    return total


def idle_share(one_step: Callable):
    """Run `one_step()` once under torch.profiler and print the device idle
    share: 1 - busy time / host-clock time, the busy time being the union of
    the device events' intervals (the profiler's buffer flushes are not
    work of the step). Needs a CUDA device: on the CPU there is no device
    to be idle, and it raises. Returns (idle share, busy ms, the
    profile)."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("idle_share measures a CUDA device's idle time "
                           "and no CUDA device is available")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = busy_us(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.name != "Buffer Flush") / 1e3
    idle = 1 - busy_ms / wall_ms
    print(f"profiled step {wall_ms:.2f} ms, kernels {busy_ms:.2f} ms: "
          f"device idle share {idle:.3f}")
    return idle, busy_ms, prof


class ExamplesPerSec:
    """Throughput meter (the reference's unused `log_time` helper,
    `manydepth/trainer.py:1521-1531`, actually wired up)."""

    def __init__(self, window: int = 50):
        self.window = window
        self._t0 = time.perf_counter()
        self._count = 0
        self.value = 0.0

    def update(self, batch_size: int) -> float:
        self._count += batch_size
        if self._count >= self.window * batch_size:
            now = time.perf_counter()
            self.value = self._count / (now - self._t0)
            self._t0 = now
            self._count = 0
        return self.value
