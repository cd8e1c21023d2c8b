"""The port's profiling utilities (`mal_tpu_torch.utils.profiling`) on the
CPU: the throughput meter against `mal_tpu`'s under one patched clock,
`time_fn` and `trace` on CPU work, the busy-time union behind the device
idle share, and `idle_share`'s refusal without a CUDA device (on the CPU
there is no device to be idle)."""

import json
import os

import pytest
import torch

from mal_tpu.utils import profiling as jprofiling
from mal_tpu_torch.utils import profiling


class _Clock:
    """A `time.perf_counter` stand-in that advances `step` a read."""

    def __init__(self, step: float):
        self.now, self.step = 0.0, step

    def __call__(self) -> float:
        self.now += self.step
        return self.now


@pytest.mark.parametrize("window,batch,step", [(3, 12, 0.25), (1, 2, 0.1),
                                               (5, 7, 1.0)])
def test_examples_per_sec_matches_mal_tpu(monkeypatch, window, batch, step):
    values = {}
    for name, module in (("port", profiling), ("mal_tpu", jprofiling)):
        monkeypatch.setattr(module.time, "perf_counter", _Clock(step))
        meter = module.ExamplesPerSec(window)
        values[name] = [meter.update(batch) for _ in range(4 * window)]
    assert values["port"] == values["mal_tpu"]
    assert values["port"][window - 1] > 0.0


def test_time_fn_on_the_cpu():
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": x * 2}

    out = profiling.time_fn(fn, torch.ones(8), iters=5, warmup=2)
    assert out["iters"] == 5 and out["mean_ms"] >= 0.0
    assert len(calls) == 7


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "trace" / "trace.json"
    assert os.path.getsize(path) > 0
    with open(path) as f:
        assert "traceEvents" in json.load(f)
    assert any("mm" in e.key for e in prof.key_averages())


@pytest.mark.parametrize("spans,want", [
    ([], 0.0), ([(0, 10)], 10.0), ([(0, 10), (5, 15)], 15.0),
    ([(20, 30), (0, 10), (2, 4)], 20.0), ([(0, 10), (10, 12)], 12.0)])
def test_busy_time_is_the_union_of_the_spans(spans, want):
    assert profiling.busy_us(spans) == want


def test_idle_share_needs_a_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.idle_share(lambda: None)
