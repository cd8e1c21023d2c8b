"""The program's spans and counters (`mal_tpu_torch.utils.profiling`):
the recorder off and on, the spans and the sync counter of one MAL step
with the temporal hint, and the spans in the operator's Chrome trace.

On the CPU: a tiny temporal-hint step (64x96, batch 2, a Swin-T
Mask2Former of 8 queries). Marked `gpu` (skipped where no CUDA device is
present, decided inside the fixture): the spans against CUPTI's launches
on the trace's clock, and the sync counter against the synchronising
operations that `torch.cuda.set_sync_debug_mode` reports. On a machine
with a card, without tests/conftest.py, which sets up JAX for the other
tests:

    python -m pytest --noconftest tests/test_torch_tracing.py -q -s
"""

import contextlib
import json
import threading
import time
import tracemalloc
import warnings

import pytest
import torch

from mal_tpu_torch.config import Config
from mal_tpu_torch.data.synthetic import synthetic_batch
from mal_tpu_torch.segment.mask2former import Mask2Former, make_seg_fn
from mal_tpu_torch.segment.msdeform import MSDeformAttn
from mal_tpu_torch.train.state import create_train_state
from mal_tpu_torch.train.step import make_train_step
from mal_tpu_torch.utils import profiling

TINY = dict(temporal=True, ins_threshold=0.0, max_instances=4, batch_size=2,
            height=64, width=96, num_depth_bins=16, distil=True,
            use_ensemble=True, loss_blc=True)
# the spans of one step and their parents
NESTING = {"mal.depth_model": "mal.step", "mal.losses": "mal.step",
           "mal.synthesis": "mal.losses", "mal.matching": "mal.synthesis",
           "mal.matching.wait": "mal.matching",
           "mal.matching.solve": "mal.matching",
           "mal.backward": "mal.step", "mal.optimizer": "mal.step"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# --------------------------------------------------------------------------
# The recorder
# --------------------------------------------------------------------------

def test_off_span_is_the_shared_no_op_and_records_nothing():
    assert profiling.span("a") is profiling.span(profiling.STEP)
    with profiling.span("a") as entered:
        profiling.count("host_syncs")
    assert entered is None
    with profiling.recording() as records:
        pass
    assert records.spans == [] and records.counts == {}


def test_off_reads_no_clock_and_allocates_nothing(monkeypatch):
    def no_clock():
        raise AssertionError("the recorder read the clock while off")

    monkeypatch.setattr(profiling.time, "time_ns", no_clock)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with profiling.span("mal.step"):
                profiling.count("host_syncs", 3)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = [tracemalloc.Filter(True, profiling.__file__)]
    grown = [d for d in after.filter_traces(mine).compare_to(
        before.filter_traces(mine), "lineno") if d.size_diff > 0]
    assert grown == []


def test_on_records_parents_steps_and_counts():
    with profiling.recording() as records:
        with profiling.span("before"):
            pass
        for _ in range(2):
            with profiling.span(profiling.STEP):
                with profiling.span("a"):
                    with profiling.span("b"):
                        profiling.count("host_syncs", 2)
                profiling.count("host_syncs")
                profiling.count("other")
    spans = records.spans
    assert [(n, p, s) for n, _, _, p, s in spans] == [
        ("before", None, None), ("mal.step", None, 0), ("a", 1, 0),
        ("b", 2, 0), ("mal.step", None, 1), ("a", 4, 1), ("b", 5, 1)]
    assert records.counts == {"host_syncs": 6, "other": 2}
    for name, start, end, parent, _ in spans:
        assert start <= end
        if parent is not None:
            assert spans[parent][1] <= start and end <= spans[parent][2]
    # nothing is recorded once the block ends
    with profiling.span("after"):
        profiling.count("host_syncs")
    assert len(spans) == 7 and records.counts["host_syncs"] == 6


def test_each_thread_keeps_its_own_stack():
    """A span opened on another thread (autograd's, a loader's) while the
    step's span is open is not its child."""
    with profiling.recording() as records:
        with profiling.span(profiling.STEP):
            worker = threading.Thread(
                target=lambda: profiling.span("elsewhere").__enter__())
            worker.start()
            worker.join(timeout=10)
            assert not worker.is_alive()
            with profiling.span("inside"):
                pass
    got = {n: (p, s, e is None) for n, _, e, p, s in records.spans}
    assert got == {"mal.step": (None, 0, False),
                   "elsewhere": (None, None, True),
                   "inside": (0, 0, False)}


def test_one_recorder_at_a_time_and_off_after_an_error():
    with pytest.raises(ValueError):
        with profiling.recording():
            with pytest.raises(RuntimeError, match="already on"):
                with profiling.recording():
                    pass
            raise ValueError
    assert profiling.span("a") is profiling.span("b")


# --------------------------------------------------------------------------
# One MAL step with the temporal hint
# --------------------------------------------------------------------------

def _tiny_step(device: torch.device, cfg: Config):
    """(state, step, batch, draws, segmenter) of a tiny step from fixed
    seeds, with a Swin-T segmenter where `cfg` has the temporal hint (its
    blocks fused on a card in fast mode, as the hint cell runs them)."""
    seg, seg_fn = None, None
    if cfg.temporal:
        seg = Mask2Former(swin_size="tiny", num_queries=8, device=device,
                          generator=torch.Generator().manual_seed(1),
                          bf16_backbone=cfg.compute_dtype == "bfloat16",
                          fused_swin=device.type == "cuda"
                          and cfg.compute_dtype == "bfloat16")
        seg_fn = make_seg_fn(seg, cfg.max_instances)
    state = create_train_state(cfg, device,
                               generator=torch.Generator().manual_seed(2))
    step = make_train_step(cfg, device, seg_fn=seg_fn)
    g = torch.Generator(device).manual_seed(3)
    batch = synthetic_batch(cfg, g, device)
    draws = {"matching_aug": torch.rand(cfg.batch_size, generator=g,
                                        device=device),
             "automask_noise": torch.randn(
                 (cfg.batch_size, 1, cfg.height, cfg.width), generator=g,
                 device=device)}
    return state, step, batch, draws, seg


def expected_syncs(cfg: Config, seg: Mask2Former | None,
                   warm: bool = False) -> int:
    """The synchronising points of a step, as the program counts them: the
    depth model scales the intrinsics once and each photometric warp
    copies its grid's scale to the device (a warp per adjacent frame of
    the teacher's depth, the student's and, with the ensemble, theirs);
    with the hint, the matching copies its costs to the host and two
    results back, and the segmenter's first forward at the step's shape
    copies each deformable layer's level sizes to the device (`warm`: an
    earlier step made that forward). The normalisation's constants are
    the segmenter's buffers and cost no copy."""
    depths = 3 if cfg.distil and cfg.use_ensemble else 2
    syncs = 1 + depths * (len(cfg.frame_ids) - 1)
    if seg is not None:
        syncs += 3
        if not warm:
            syncs += sum(isinstance(m, MSDeformAttn) for m in seg.modules())
    return syncs


@pytest.fixture(scope="module")
def cpu_steps():
    """One step from the same state with the recorder off and on: the
    metrics, the parameters after it, and the records."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    cpu = torch.device("cpu")
    try:
        out = {}
        for on in (False, True):
            state, step, batch, draws, seg = _tiny_step(cpu, Config(**TINY))
            with (profiling.recording() if on
                  else contextlib.nullcontext()) as records:
                state, metrics = step(state, batch, 0.0, draws=draws)
            out[on] = (metrics, {k: p.detach().clone() for k, p
                                 in state.model.named_parameters()}, records)
        out["seg"] = seg
        return out
    finally:
        torch.set_num_threads(n)


def test_step_is_the_same_with_the_recorder_on_and_off(cpu_steps):
    (m_off, p_off, _), (m_on, p_on, records) = cpu_steps[False], cpu_steps[True]
    assert records.spans
    assert m_off.keys() == m_on.keys()
    for k in m_off:
        torch.testing.assert_close(m_on[k], m_off[k], rtol=0, atol=0, msg=k)
    for k in p_off:
        torch.testing.assert_close(p_on[k], p_off[k], rtol=0, atol=0, msg=k)


def test_step_spans_nest_and_count_the_syncs(cpu_steps):
    records = cpu_steps[True][2]
    spans = records.spans
    names = [s[0] for s in spans]
    assert names.count("mal.step") == 1
    assert names.count("mal.segmenter") == 3
    for name in NESTING:
        assert names.count(name) == 1, name
    for name, _, _, parent, _ in spans:
        if name in NESTING:
            assert spans[parent][0] == NESTING[name], name
    # the current frame's forward in the losses, the warped frames' in the
    # synthesis
    seg_parents = sorted(spans[p][0] for n, _, _, p, _ in spans
                         if n == "mal.segmenter")
    assert seg_parents == ["mal.losses", "mal.synthesis", "mal.synthesis"]
    (step,) = [s for s in spans if s[0] == "mal.step"]
    for name, start, end, _, index in spans:
        assert index == 0, name
        assert step[1] <= start <= end <= step[2], name
    assert records.counts == {
        "host_syncs": expected_syncs(Config(**TINY), cpu_steps["seg"])}


def test_a_step_without_the_hint_records_no_segmenter_and_its_syncs():
    cfg = Config(batch_size=2, height=64, width=96, num_depth_bins=16)
    state, step, batch, draws, _ = _tiny_step(torch.device("cpu"), cfg)
    with profiling.recording() as records:
        step(state, batch, 0.0, draws=draws)
    assert [(n, p) for n, _, _, p, _ in records.spans] == [
        ("mal.step", None), ("mal.depth_model", 0), ("mal.losses", 0),
        ("mal.backward", 0), ("mal.optimizer", 0)]
    assert records.counts == {"host_syncs": expected_syncs(cfg, None)}


# --------------------------------------------------------------------------
# The operator's trace
# --------------------------------------------------------------------------

def test_trace_lays_the_spans_on_the_trace_clock(tmp_path):
    """A span and a `record_function` probe opened inside it line up on the
    Chrome trace's clock within 1 ms. The span shows twice: on its own
    track, and as the profiler's own range of its name."""
    with torch.profiler.record_function("warm"):
        pass
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer"):
            with torch.profiler.record_function("probe"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    (outer,) = [e for e in events
                if e.get("name") == "outer" and e.get("cat") == "span"]
    (outer_range,) = [e for e in events
                      if e.get("name") == "outer" and e.get("cat") != "span"]
    assert outer_range["ph"] == "X"
    (probe,) = [e for e in events if e.get("name") == "probe"]
    assert outer["ph"] == "X" and outer["cat"] == "span"
    assert outer["tid"] == profiling.SPAN_TRACK
    assert outer["args"] == {"parent": None, "step": None}
    assert abs(probe["ts"] - outer["ts"]) < 1000.0
    assert abs((probe["ts"] + probe["dur"])
               - (outer["ts"] + outer["dur"])) < 1000.0
    assert profiling.span("after") is profiling.span("off")


def test_spans_join_a_trace_whose_times_are_unix_time(tmp_path):
    """A trace without `baseTimeNanoseconds` counts `ts` from the epoch;
    a span still open when recording ended is left out."""
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": []}))
    records = profiling.Records(spans=[("a", 5_000, 9_500, None, 0),
                                       ("open", 6_000, None, 0, 0)])
    profiling._add_spans(str(path), records)
    events = json.loads(path.read_text())["traceEvents"]
    assert [(e["ph"], e["name"]) for e in events] == [("M", "thread_name"),
                                                      ("X", "a")]
    assert (events[1]["ts"], events[1]["dur"]) == (5.0, 4.5)
    assert events[1]["args"] == {"parent": None, "step": 0}


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.mark.gpu
def test_launches_land_inside_their_spans_on_the_trace_clock(cuda, tmp_path):
    """Under a profiler that records the device alone, each launch (CUPTI's
    runtime and driver events) made inside a span falls inside it on the
    trace's clock; prints the smallest margins at either end."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(512, 512, device=cuda)
    (x @ x).sum().item()
    with profiling.recording() as records, \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            with profiling.span("probe"):
                for _ in range(5):
                    x = (x @ x).tanh()
            time.sleep(0.002)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    kernels = {e["args"].get("correlation") for e in doc["traceEvents"]
               if e.get("cat") == "kernel"}
    launches = [(base + e["ts"] * 1e3, base + (e["ts"] + e["dur"]) * 1e3)
                for e in doc["traceEvents"]
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("args", {}).get("correlation") in kernels]
    spans = [(s, e) for _, s, e, _, _ in records.spans]
    assert len(spans) == 20 and len(launches) >= 200
    margins = []
    for a, b in launches:
        inside = [(a - s, e - b) for s, e in spans if s <= a and b <= e]
        assert len(inside) == 1, (a, b)
        margins.append(inside[0])
    print(f"\nlaunches {len(launches)}: after their span's start by "
          f"{min(m[0] for m in margins) / 1e3:.1f}-"
          f"{max(m[0] for m in margins) / 1e3:.1f} us, before its end by "
          f"{min(m[1] for m in margins) / 1e3:.1f}-"
          f"{max(m[1] for m in margins) / 1e3:.1f} us")


@pytest.mark.gpu
def test_sync_counter_equals_the_synchronising_operations(cuda):
    """One tiny step of the hint cell's configuration (fast mode) after a
    warm-up step: `host_syncs` equals the synchronising operations that
    the sync debug mode reports, none of them in the segmenter's three
    forwards (replays of its graph); prints where they happen."""
    cfg = Config(**TINY, compute_dtype="bfloat16", cv_mxu_precision="default")
    state, step, batch, draws, seg = _tiny_step(cuda, cfg)
    state, _ = step(state, batch, 0.0, draws=draws)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught, \
                profiling.recording() as records:
            warnings.simplefilter("always")
            state, _ = step(state, batch, 0.0, draws=draws)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchronizing" in str(w.message)]
    sites: dict = {}
    for w in syncs:
        key = f"{w.filename}:{w.lineno}"
        sites[key] = sites.get(key, 0) + 1
    print("\nsynchronising operations:", json.dumps(sites, indent=1))
    assert (len(syncs) == records.counts["host_syncs"]
            == expected_syncs(cfg, seg, warm=True))
    assert records.counts["seg_graph_replays"] == 3
    assert "seg_graph_captures" not in records.counts
