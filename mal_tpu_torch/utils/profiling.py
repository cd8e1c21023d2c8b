"""Profiling and timing utilities, the port's counterpart of
`mal_tpu.utils.profiling`, and the one definition of the device timings
`chip_smoke.py` prints.

The reference has only wall-clock prints (`manydepth/evaluate_depth.py:
175-176`, `trainer.py:1521-1531`). Here: the program's spans and counters
at its layer boundaries (`span`, `count`, `recording`), a `torch.profiler`
trace exported for Chrome's trace viewer with those spans in it,
steady-state timing by CUDA events, and a step's device idle share.

The spans are stamped with `time.time_ns()`, the clock of the profiler's
Chrome trace (`baseTimeNanoseconds` + `ts` x 1000), so that they can be
laid over a trace that records the device alone, and the host, unrecorded
by the profiler, runs at its own speed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Callable

import torch

# the span around one training step: every span inside it carries its index
STEP = "mal.step"
# the Chrome trace's track (tid) of the spans, in the profiled process
SPAN_TRACK = 0


@dataclasses.dataclass
class Records:
    """What `recording()` gathered. `spans`: (name, start_ns, end_ns,
    parent, step) in the order they opened, times from `time.time_ns()`,
    `parent` the index of the enclosing span on the same thread (None at
    the top), `step` the index of the enclosing `STEP` span among them
    (None outside one); a span still open when recording ended has
    `end_ns` None. `counts`: each counter's total."""
    spans: list = dataclasses.field(default_factory=list)
    counts: dict = dataclasses.field(default_factory=dict)


class _Recorder:
    def __init__(self):
        self.records = Records()
        self.steps = 0
        self.lock = threading.Lock()
        self.local = threading.local()   # each thread's stack of open spans

    def stack(self) -> list:
        if not hasattr(self.local, "stack"):
            self.local.stack = []
        return self.local.stack

    def open(self, name: str) -> int:
        stack = self.stack()
        parent = stack[-1] if stack else None
        spans = self.records.spans
        with self.lock:
            if name == STEP:
                step, self.steps = self.steps, self.steps + 1
            else:
                step = None if parent is None else spans[parent][4]
            index = len(spans)
            spans.append((name, time.time_ns(), None, parent, step))
        stack.append(index)
        return index

    def close(self, index: int) -> None:
        end = time.time_ns()
        self.stack().pop()
        spans = self.records.spans
        with self.lock:
            name, start, _, parent, step = spans[index]
            spans[index] = (name, start, end, parent, step)

    def count(self, name: str, n: int) -> None:
        counts = self.records.counts
        with self.lock:
            counts[name] = counts.get(name, 0) + n


class _Span:
    __slots__ = ("recorder", "name", "index", "range")

    def __init__(self, recorder: _Recorder, name: str, profiled: bool):
        self.recorder, self.name = recorder, name
        self.range = torch.profiler.record_function(name) if profiled else None

    def __enter__(self):
        self.index = self.recorder.open(self.name)
        if self.range is not None:
            self.range.__enter__()

    def __exit__(self, *exc) -> None:
        if self.range is not None:
            self.range.__exit__(*exc)
        self.recorder.close(self.index)


_recorder: _Recorder | None = None
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that records the block as the span `name` while
    `recording()` is on, and while a `torch.profiler` is on also opens a
    `record_function` range of that name, so that the span shows in the
    profiler's trace; both off, the one shared no-op, with one flag read,
    no clock read and nothing allocated."""
    profiled = torch.autograd._profiler_enabled()
    if _recorder is None:
        return torch.profiler.record_function(name) if profiled else _NO_SPAN
    return _Span(_recorder, name, profiled)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` while `recording()` is on."""
    if _recorder is None:
        return
    _recorder.count(name, n)


@contextlib.contextmanager
def recording():
    """Record the spans and counters of the block; yields the `Records`,
    which hold them once the block ends. Raises RuntimeError when a
    recording is on already."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("the recorder is already on")
    recorder = _Recorder()
    _recorder = recorder
    try:
        yield recorder.records
    finally:
        _recorder = None


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with `torch.profiler` (the CPU, and CUDA when a
    card is present) and write `log_dir/trace.json` for Chrome's trace
    viewer (chrome://tracing, Perfetto), with the program's spans of the
    block as complete events on a track of their own (`SPAN_TRACK`,
    category "span", args `parent` and `step` as `Records` has them).
    Yields the profile, whose `key_averages()` gives the table."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with recording() as records, profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, records)


def _add_spans(path: str, records: Records) -> None:
    """Append the closed spans to the Chrome trace at `path`, whose `ts`
    count microseconds from its `baseTimeNanoseconds` (Unix time; 0 where
    a trace has no base, whose `ts` are Unix time)."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = doc["traceEvents"]
    events.append({"ph": "M", "name": "thread_name", "pid": pid,
                   "tid": SPAN_TRACK, "args": {"name": "mal_tpu_torch spans"}})
    for name, start, end, parent, step in records.spans:
        if end is not None:
            events.append({"ph": "X", "cat": "span", "name": name, "pid": pid,
                           "tid": SPAN_TRACK, "ts": (start - base) / 1e3,
                           "dur": (end - start) / 1e3,
                           "args": {"parent": parent, "step": step}})
    with open(path, "w") as f:
        json.dump(doc, f)


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
