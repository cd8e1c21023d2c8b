"""A run of each cell at a tiny size on the CPU, through the harness's
own set-up, steps, readings and comparison (the look for a card
skipped): the port against the plain reference, the result line's keys,
and `correct` coming out false under each fault that a cell can have and
under the control. Also: the generator's dynamic-object masks, the
dispatch to a method's reference, and the hint cell's inputs and
reference readings as they were before that dispatch."""

import hashlib
import io
import json
import multiprocessing
import socket
import contextlib

import pytest
import torch

from gpubench import compare, faults, run, spec, traffic
from gpubench.reference import runner
from gpubench.tests.tiny import args, full_cell, tiny_cell
from gpubench.tools import readings

CELLS = ["mal_swinl_bf16.temporal_hint", "mal_distil_fp32.dp4",
         "dynamicdepth_fp32.precomputed_doj"]
LISTED = [CELLS[0], CELLS[2]]          # the cells BENCHMARK.json lists
DYNAMIC = CELLS[2]
CPU = torch.device("cpu")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
# the largest gap of the port's plain path on the CPU against the frozen
# copy: 0 where the copy runs the port's own plain kernels; DynamicDepth's
# reference takes the cost volume's grid_sample twin where the port's K6
# plain version sums the bilinear corners in the kernel's order, and Adam
# makes the worst leaf's change of that rounding (9e-4 at seed 2**31 + 11)
CPU_GAP = {DYNAMIC: 2e-3}


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
    # on the CPU the port's plain path and the frozen copy agree to the bit,
    # or where the copy has a twin of other arithmetic, to its rounding
    assert all(v <= CPU_GAP.get(name, 0.0) for k, (v, _)
               in got["compared"].items() if k.endswith("_gap"))
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


@pytest.mark.parametrize("fault", ["no_domd", "k6_zeroed"])
def test_dynamic_fault_is_not_correct(fault):
    """DynamicDepth's own faults: the step given the batch without its
    dynamic-object masks, so that it skips the DOMD warp; K6's output
    zeroed, so that no pixel of the cost volume is confident."""
    cell = tiny_cell(DYNAMIC)
    cell.workload["limits"] = full_limits(DYNAMIC)
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


@pytest.mark.parametrize("name", LISTED)
def test_cell_finds_its_traffic_mix(name):
    """The traffic mix is the data file `BENCHMARK.json` names, read by the
    one generator."""
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
    ok, _ = compare.judge(
        compare.numbers(got, ref, cell.workload.get("leaf_groups")),
        full_limits(name))
    assert not ok


def test_doj_masks_are_moved_boxes():
    """The mix's dynamic-object masks at the cell's own size: (B, H, W)
    float32 in {0, 1}; frame 0 the union of the mix's number of boxes, of
    its widths and heights; frames -1 and +1 those boxes moved by -(dx, dy)
    and +(dx, dy) within its shifts, clipped to the frame."""
    cell = full_cell(DYNAMIC)
    doj, pc = cell.traffic["doj"], cell.config["port_config"]
    B, H, W = pc["batch_size"], pc["height"], pc["width"]
    g = torch.Generator().manual_seed(traffic.sub_seed(2 ** 33 + 1, 0, 0))
    masks = traffic.make_doj_masks(doj, pc, B, g, CPU)
    assert set(masks) == {"doj_mask", "doj_mask-1", "doj_mask+1"}
    for m in masks.values():
        assert m.shape == (B, H, W) and m.dtype == torch.float32
        assert set(m.unique().tolist()) <= {0.0, 1.0}
    g = torch.Generator().manual_seed(traffic.sub_seed(2 ** 33 + 1, 0, 0))
    count = traffic._uniform_ints(torch.rand((B, 1), generator=g),
                                  doj["boxes"])
    u = torch.rand((6, B, doj["boxes"][1]), generator=g)
    w = traffic._uniform_ints(u[0], doj["width"])
    h = traffic._uniform_ints(u[1], doj["height"])
    dx = traffic._uniform_ints(u[4], doj["shift_x"])
    dy = traffic._uniform_ints(u[5], doj["shift_y"])
    assert count.min() >= doj["boxes"][0] and count.max() <= doj["boxes"][1]
    assert count.unique().numel() > 1
    for drawn, (lo, hi) in ((w, doj["width"]), (h, doj["height"]),
                            (dx, doj["shift_x"]), (dy, doj["shift_y"])):
        assert drawn.min() >= lo and drawn.max() <= hi
    # each frame is exactly the union of the item's first `count` boxes,
    # frame f's moved by f (dx, dy), painted here box by box
    x0 = (u[2] * (W - w + 1)).floor().long()
    y0 = (u[3] * (H - h + 1)).floor().long()
    for f, key in ((0, "doj_mask"), (-1, "doj_mask-1"), (1, "doj_mask+1")):
        want = torch.zeros((B, H, W))
        for b in range(B):
            for i in range(int(count[b, 0])):
                top = int(y0[b, i] + f * dy[b, i])
                left = int(x0[b, i] + f * dx[b, i])
                want[b, max(top, 0):max(top + int(h[b, i]), 0),
                     max(left, 0):max(left + int(w[b, i]), 0)] = 1.0
        assert torch.equal(masks[key], want), key
    cover = masks["doj_mask"].mean(dim=(1, 2))
    assert 0.0 < float(cover.min()) and float(cover.max()) < 0.6


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def test_hint_cell_is_unmoved():
    """The hint cell's pool batches, draws and reference readings at the
    tiny size equal what the harness gave before a cell could choose its
    method (a mix without `doj`, ManyDepth's reference)."""
    cell = tiny_cell(CELLS[0])
    seed = 2 ** 31 + 5
    digest = hashlib.sha256()
    for j in range(cell.traffic["pool"]):
        batch, draws = traffic.shard_inputs(cell.traffic,
                                            cell.config["port_config"], seed,
                                            j, 0, CPU)
        for name, t in _leaves({"batch": batch, "draws": draws}):
            digest.update(name.encode())
            digest.update(t.contiguous().numpy().tobytes())
    assert digest.hexdigest() == (
        "79b7417eb98db31f4679ab85ea564354266931f77c4d8249322a7d20f3262594")
    ref = runner.readings(cell, seed, CPU)
    assert ref["loss"] == [0.876479983329773, 0.8274279236793518,
                           1.1436388492584229]
    assert sum(ref["grad"]) == pytest.approx(9.813509928557323, rel=1e-9)
    assert sum(ref["change"]) == pytest.approx(0.01720544491314513, rel=1e-9)
    assert [ref["state"][k] for k in sorted(ref["state"])] == [
        0.8675498962402344, 0.0071816458366811275, 0.47459113597869873,
        2.602649688720703, 0.021544937044382095, 0.3123781979084015,
        28.348302841186523, 9.71812629699707, 0.10013831406831741]


def test_leaf_group_numbers():
    """A workload's leaf group reads the gap of the group's whole norms,
    over its kept leaves only; a group that matches no leaf is refused."""
    names = ["encoder.a", "depth.b", "pose.c", "encoder.tiny"]
    ref = {"names": names, "loss": [1.0], "grad": [3.0, 4.0, 1.0, 1e-6],
           "change": [3.0, 4.0, 9.0, 5.0], "state": {"x": 1.0}}
    prog = dict(ref, grad=[6.0, 8.0, 1.0, 1.0], change=[0.0, 5.0, 9.0, 0.0])
    got = compare.numbers(prog, ref, {"student": ["encoder.", "depth."]})
    assert got["grad_norm_gap.student"] == pytest.approx(1.0)
    assert got["change_norm_gap.student"] == pytest.approx(0.0)
    with pytest.raises(ValueError, match="no leaf"):
        compare.numbers(prog, ref, {"none": ["mono."]})


def test_method_without_reference_raises():
    config = dict(full_cell(CELLS[0]).config)
    config["port_config"] = dict(config["port_config"], method="nomethod")
    with pytest.raises(FileNotFoundError,
                       match="gpubench/reference/nomethod/"):
        runner.build(config, 0, CPU, 2)


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
