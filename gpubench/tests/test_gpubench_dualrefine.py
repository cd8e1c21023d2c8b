"""DualRefine's cell, `dualrefine_fp32.kitti_triplets`, at the tiny size on
the CPU (`tiny.tiny_cell`): the port against its plain reference
(`gpubench/reference/dualrefine/`) through the harness's own set-up and
comparison, `correct` false under each of its faults
(`dualrefine_faults.py`) and under the control, its traffic mix found by
`BENCHMARK.json`'s name, its two per-layer readers, and a run that loads
no JAX. One reference reading of the seed is shared by the fault and
control tests. Marked `gpu` (skipped where no CUDA device is present):
both readers positive on a traced tiny run on the card,

    python -m pytest --noconftest gpubench/tests/test_gpubench_dualrefine.py -q
"""

import contextlib
import dataclasses
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from gpubench import compare, dualrefine_faults, run, spec, trace, traffic
from gpubench import train_cell
from gpubench.reference import runner
from gpubench.tests.tiny import args, full_cell, tiny_cell
from gpubench.tools import readings

NAME = "dualrefine_fp32.kitti_triplets"
CPU = torch.device("cpu")
SEED = 2 ** 31 + 13
SPANS = {"deq_solve_device_ms": "mal.dualref.solve",
         "gauss_newton_device_ms": "mal.dualref.gauss_newton"}
ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cell():
    """The tiny cell, judged by the full cell's limits."""
    c = tiny_cell(NAME)
    c.workload["limits"] = dict(full_cell(NAME).workload["limits"])
    return c


@pytest.fixture(scope="module")
def ref(cell):
    return runner.readings(cell, SEED, CPU)


def program(cell, fault=None) -> dict:
    """The program's readings of its compared steps, a window of 1 step."""
    short = dataclasses.replace(cell, workload=dict(cell.workload,
                                                    min_steps=1))
    return train_cell.run(short, SEED, 0.0, False, CPU, 0, 1,
                          time.perf_counter(), fault=fault).readings


def judged(cell, got: dict, ref: dict) -> bool:
    ok, _ = compare.judge(
        compare.numbers(got, ref, cell.workload.get("leaf_groups")),
        cell.workload["limits"])
    return ok


def test_tiny_cell_is_correct_against_the_reference(cell):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.report(run.measure(cell, args(SEED), CPU, 0, 1, []))
    assert rc == 0
    got = json.loads(out.getvalue().strip().splitlines()[-1])
    assert got["correct"] is True and got["failed"] == 0
    # the port's plain path and the frozen copy agree to the bit here
    assert all(v == 0.0 for k, (v, _) in got["compared"].items()
               if "gap" in k)
    assert "grad_norm_gap.refinement" in got["compared"]
    # DEQDepthPose returns a tuple, whose cost-volume confidence the
    # comparison does not read
    assert "confidence_flips" not in got["compared"]
    assert set(got["metrics"]) == {m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize("fault", sorted(dualrefine_faults.FAULTS))
def test_fault_is_not_correct(cell, ref, fault):
    got = program(cell, dualrefine_faults.FAULTS[fault])
    assert not judged(cell, got, ref)


def test_control_is_not_correct(cell, ref):
    assert not judged(cell, readings.variant_readings(cell, SEED, "control",
                                                      CPU), ref)


def test_reference_refuses_what_it_does_not_copy(cell):
    for change in ({"deq_ift": True}, {"robust_pose_loss": True},
                   {"deq_solver": "broyden"},
                   {"compute_dtype": "bfloat16"}):
        config = dict(cell.config,
                      port_config={**cell.config["port_config"], **change})
        with pytest.raises(NotImplementedError, match=next(iter(change))):
            runner.build(config, 0, CPU, 2)


def test_cell_finds_its_traffic_mix():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    entry = next(w for w in bench["workloads"] if w["name"] == NAME)
    cell = spec.load_cell(NAME)
    assert entry["traffic"] == "kitti_triplets" and cell.chips == 1
    assert cell.traffic == json.loads(
        (spec.HERE / "mixes" / "kitti_triplets.json").read_text())
    assert cell.config["port_config"]["method"] == "dualrefine"
    assert runner.method_package(cell.config).__name__ == (
        "gpubench.reference.dualrefine")
    assert {m["name"] for m in cell.per_layer} == set(SPANS)
    pc = tiny_cell(NAME).config["port_config"]
    batch, draws = traffic.shard_inputs(cell.traffic, pc, 4, 0, 0, CPU)
    fx, fy, cx, cy = cell.traffic["intrinsics"]
    assert batch["K"][0, 0, 0] == pytest.approx(fx * pc["width"])
    assert batch["K"][0, 1, 1] == pytest.approx(fy * pc["height"])
    assert draws["automask_noise"].shape == (2, 1, 64, 96)


def _device_op(trace_: trace.Trace, corr: int, launch_ts: float,
               dur: float, tid: int) -> None:
    trace_.device.append(("kernel", launch_ts + 5.0, dur, corr))
    trace_.launches[corr] = (launch_ts, tid)


def test_readers_read_the_device_time_launched_inside_their_spans():
    """On a trace with the spans' host events and device operations
    launched inside and outside them: each reader gives the device ms a
    step of the operations launched inside its span on the span's thread,
    and nothing on a trace without the span."""
    t = trace.Trace(device=[], launches={}, host=[
        ("mal.dualref.solve", 100.0, 100.0, 1),
        ("mal.dualref.gauss_newton", 150.0, 20.0, 1),
        ("mal.dualref.gauss_newton", 300.0, 20.0, 1)], window_s=1.0, steps=2)
    _device_op(t, 1, 110.0, 400.0, 1)    # the solve's, outside GN
    _device_op(t, 2, 160.0, 1000.0, 1)   # GN inside the solve
    _device_op(t, 3, 310.0, 600.0, 1)    # GN outside the solve
    _device_op(t, 4, 310.0, 50.0, 7)     # another thread: neither's
    _device_op(t, 5, 500.0, 50.0, 1)     # outside both
    ctx = run.Context(cell=None, run=train_cell.Run(host_trace=t),
                      others=[], global_batch=2)
    got = {m: run.load_reader(m)(ctx) for m in SPANS}
    assert got["deq_solve_device_ms"] == pytest.approx(1.4 / 2)
    assert got["gauss_newton_device_ms"] == pytest.approx(1.6 / 2)
    bare = trace.Trace(device=list(t.device), launches=dict(t.launches),
                       host=[], window_s=1.0, steps=2)
    ctx = run.Context(cell=None, run=train_cell.Run(host_trace=bare),
                      others=[], global_batch=2)
    assert all(run.load_reader(m)(ctx) is None for m in SPANS)
    ctx = run.Context(cell=None, run=train_cell.Run(), others=[],
                      global_batch=2)
    assert all(run.load_reader(m)(ctx) is None for m in SPANS)


def test_port_spans_show_in_the_harness_host_trace():
    """The port's spans reach the host trace that the readers read
    (`trace.profile_steps` with the host recorded)."""
    from mal_tpu_torch.utils import profiling

    def steps(n):
        for _ in range(n):
            with profiling.span("mal.dualref.solve"):
                with profiling.span("mal.dualref.gauss_newton"):
                    torch.ones(32, 32) @ torch.ones(32, 32)

    t = trace.profile_steps(steps, 2, lambda: None, time.perf_counter,
                            host=True)
    names = [h[0] for h in t.host]
    assert names.count("mal.dualref.solve") == 2
    assert names.count("mal.dualref.gauss_newton") == 2


SCRIPT = r"""
import dataclasses, json, sys
import torch
torch.set_num_threads(2)
from gpubench import run
from gpubench.tests.tiny import args, tiny_cell
cell = tiny_cell("dualrefine_fp32.kitti_triplets")
cell = dataclasses.replace(cell, workload=dict(cell.workload,
                                                compared_steps=1))
result = run.measure(cell, args(3), torch.device("cpu"), 0, 1, [])
assert result["correct"], result
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_run_loads_no_jax(tmp_path):
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=600,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                               "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "mal_tpu"}
    assert "mal_tpu_torch" in top


@pytest.mark.gpu
def test_readers_are_positive_on_a_traced_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = tiny_cell(NAME)
    device = torch.device("cuda", 0)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.report(run.measure(c, args(SEED, trace=1), device, 0, 1,
                                    []))
    assert rc == 0
    got = json.loads(out.getvalue().strip().splitlines()[-1])
    for name in SPANS:
        assert got["metrics"][name]["value"] > 0, name
    assert (got["metrics"]["gauss_newton_device_ms"]["value"]
            < got["metrics"]["deq_solve_device_ms"]["value"])


@pytest.mark.gpu
def test_control_at_cell_size_is_not_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = full_cell(NAME)
    device = torch.device("cuda")
    ref = runner.readings(c, 21, device)
    got = readings.variant_readings(c, 21, "control", device)
    ok, table = compare.judge(
        compare.numbers(got, ref, c.workload.get("leaf_groups")),
        c.workload["limits"])
    assert not ok, table
