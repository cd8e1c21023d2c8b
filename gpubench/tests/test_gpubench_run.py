"""A run of each cell at a tiny size on the CPU, through the harness's
own set-up, steps, readings and comparison (the look for a card
skipped): the port against the plain reference, the result line's keys,
and `correct` coming out false under each fault that a cell can have and
under the control."""

import io
import json
import multiprocessing
import socket
import contextlib

import pytest
import torch

from gpubench import compare, faults, run
from gpubench.reference import runner
from gpubench.tests.tiny import args, full_cell, tiny_cell
from gpubench.tools import readings

CELLS = ["mal_swinl_bf16.temporal_hint", "mal_distil_fp32.dp4"]
CPU = torch.device("cpu")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def line(cell, seed: int, trace: int = 0, fault=None) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.report(run.measure(cell, args(seed, trace), CPU, 0, 1, [],
                                    fault=fault))
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("name", CELLS)
def test_port_matches_reference_and_line_has_contract_keys(name):
    got = line(tiny_cell(name), 2 ** 31 + 11)
    assert list(got) == KEYS + ["compared"]
    assert got["correct"] is True
    # on the CPU the port's plain path and the frozen copy agree to the bit
    assert all(v == 0.0 for k, (v, _) in got["compared"].items()
               if k.endswith("_gap"))
    cell = tiny_cell(name)
    assert set(got["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert got["attempted"] >= 2 and got["failed"] == 0


def test_traced_line_has_breakdown_and_window():
    got = line(tiny_cell(CELLS[0]), 5, trace=1)
    assert list(got) == KEYS + ["breakdown", "compared"]
    assert set(got["breakdown"]) == {"device_ops", "idle_gaps"}
    assert got["device"]["window_s"] > 0
    # the CPU profile holds no device operation: every device reader is
    # silent, and the MFU has no FLOP count at this size
    assert got["metrics"] == {}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    cell = tiny_cell(name)
    cell.workload["limits"] = full_limits(name)
    got = line(cell, 7, fault=faults.FAULTS[fault])
    assert got["correct"] is False


def test_segmenter_fault_is_not_correct():
    """K5 broken where it runs (its output negated): the segmenter's own
    number catches it, whatever the depth model's numbers read."""
    name = CELLS[0]
    cell = tiny_cell(name)
    limits = full_limits(name)
    cell.workload["limits"] = limits
    got = line(cell, 7, fault=faults.FAULTS["k5_negated"])
    assert got["correct"] is False
    assert got["compared"]["seg_features_gap"][0] > limits["seg_features_gap"]


@pytest.mark.parametrize("name", CELLS[:1])
def test_cell_finds_its_traffic_mix(name):
    """The traffic mix is the data file `BENCHMARK.json` names, read by the
    one generator."""
    from gpubench import spec, traffic

    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    entry = next(w for w in bench["workloads"] if w["name"] == name)
    cell = spec.load_cell(name)
    assert cell.traffic == json.loads(
        (spec.HERE / "mixes" / f"{entry['traffic']}.json").read_text())
    pc = tiny_cell(name).config["port_config"]
    batch, draws = traffic.shard_inputs(cell.traffic, pc, 4, 0, 0, CPU)
    fx, fy, cx, cy = cell.traffic["intrinsics"]
    assert batch["K"][0, 0, 0] == pytest.approx(fx * pc["width"])
    assert batch["K"][0, 1, 2] == pytest.approx(cy * pc["height"])
    with pytest.raises(ValueError, match="frames"):
        traffic.shard_inputs(dict(cell.traffic, frames="kitti"), pc, 4, 0, 0,
                             CPU)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    ref = runner.readings(cell, 3, CPU)
    got = readings.variant_readings(cell, 3, "control", CPU)
    ok, _ = compare.judge(compare.numbers(got, ref), full_limits(name))
    assert not ok


def full_limits(name: str) -> dict:
    """The cell's limits, without the rank gap in one process."""
    return {k: v for k, v in full_cell(name).workload["limits"].items()
            if k != "rank_gap"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank: int, port: int, fault: str | None, queue) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    cell = tiny_cell(CELLS[1], chips=2)
    result = run.measure(cell, args(9), CPU, rank, 2, [],
                         fault=faults.FAULTS[fault] if fault else None)
    if rank == 0:
        queue.put(result)


def two_processes(fault: str | None) -> dict:
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, port, fault, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    result = queue.get(timeout=600)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    return result


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_two_processes(fault):
    """Two gloo processes of 2 items each against the reference's step on
    the global 4: sound, they agree and hold the same parameters; with the
    exchange left out, each steps alone and `correct` is false."""
    got = two_processes(fault)
    if fault is None:
        assert got["correct"] is True
        assert got["compared"]["rank_gap"][0] == 0.0
        assert got["compared"]["loss_gap"][0] < 1e-5
    else:
        assert got["correct"] is False
        assert got["compared"]["rank_gap"][0] > 0.0
