"""The port's profiling utilities (`mal_tpu_torch.utils.profiling`) on the
CPU: `trace` on CPU work, the busy-time union behind the device idle
share, and `idle_share`'s refusal without a CUDA device (on the CPU there
is no device to be idle). The spans and counters:
tests/test_torch_tracing.py."""

import json
import os

import pytest
import torch

from mal_tpu_torch.utils import profiling


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
